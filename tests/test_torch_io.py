"""Port: checkpoints on one device (``tests/test_io.py``'s one-device
cases, run on ``stoke_tpu_torch``).

A two-layer MLP (``w1 [8, 32]``, ``w2 [32, 4]``, Adam) trains on seeded
numpy batches, as in the JAX tests; GPT-tiny with dropout carries the
bit-for-bit resume. Port against port, every comparison is exact: a
resumed run computes the same function on the same tensors. The last
cases hold the JAX loader against a port tag and the later-slice
refusals.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

import stoke_tpu_torch as port
from stoke_tpu_torch import io_ops
from stoke_tpu_torch.configs import CheckpointConfig, CheckpointFormat
from stoke_tpu_torch.io_ops import _INFLIGHT_TAGS, _prune_old, checkpoint_tag
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.ops import make_flash_attention

pytestmark = pytest.mark.torch_port


class MLP(nn.Module):
    """``relu(x @ w1) @ w2``, the JAX tests' ``mlp``, from a seed."""

    def __init__(self, seed: int = 5):
        super().__init__()
        r = np.random.default_rng(seed)
        self.w1 = nn.Parameter(torch.from_numpy(
            r.normal(size=(8, 32)).astype(np.float32) * 0.1))
        self.w2 = nn.Parameter(torch.from_numpy(
            r.normal(size=(32, 4)).astype(np.float32) * 0.1))

    def forward(self, x):
        return torch.relu(x @ self.w1) @ self.w2


def mse(out, y):
    return ((out - y) ** 2).mean()


def make(configs=(), max_keep=None, fmt=CheckpointFormat.consolidated,
         **kw):
    cfgs = list(configs)
    if not any(isinstance(c, CheckpointConfig) for c in cfgs):
        cfgs.append(CheckpointConfig(format=fmt, max_to_keep=max_keep))
    return port.Stoke(MLP(), port.StokeOptimizer(torch.optim.Adam, lr=1e-2),
                      mse, batch_size_per_device=32, device="cpu",
                      configs=cfgs, **kw)


def train_a_bit(s, steps=3):
    r = np.random.default_rng(1)
    W = r.normal(size=(8, 4)).astype(np.float32)
    for _ in range(steps):
        x = r.normal(size=(32, 8)).astype(np.float32)
        y = (x @ W).astype(np.float32)
        s.backward(s.loss(s.model(x), y))
        s.step()
    return s


def opt_tensors(s):
    """Each optimizer state tensor, by parameter name and key."""
    names = {p: n for n, p in s.model_access.named_parameters()}
    return {(names[p], k): v.clone() for p, st in s.optimizer.state.items()
            for k, v in st.items() if torch.is_tensor(v)}


def assert_same_state(a, b):
    for (n, p), (_, q) in zip(a.model_access.state_dict().items(),
                              b.model_access.state_dict().items()):
        assert torch.equal(p, q), n
    oa, ob = opt_tensors(a), opt_tensors(b)
    assert oa.keys() == ob.keys()
    for k in oa:
        assert torch.equal(oa[k], ob[k]), k


def test_roundtrip_single_device(tmp_path):
    s = train_a_bit(make())
    path = str(tmp_path / "ckpt")
    tag_dir = s.save(path, name="test", extras={"note": "hello"})
    assert tag_dir.endswith("stoke-test-backward-step-3")
    assert sorted(os.listdir(tag_dir)) == [
        "extras.pkl", "meta.json", "opt_state.npz", "port.pkl",
        "scaler_state.npz", "variables.npz"]
    with open(os.path.join(tag_dir, "meta.json")) as f:
        meta = json.load(f)
    assert sorted(meta) == ["counters", "format", "name", "status"]
    assert meta["counters"] == {"backward_step": 3, "grad_accum_step": 0,
                                "optimizer_step": 3}
    assert meta["format"] == "consolidated" and meta["name"] == "test"
    assert meta["status"] == s.status.to_dict()
    with np.load(os.path.join(tag_dir, "opt_state.npz")) as z:
        assert sorted(z.files) == ["w1/exp_avg", "w1/exp_avg_sq", "w1/step",
                                   "w2/exp_avg", "w2/exp_avg_sq", "w2/step"]

    s2 = make()
    extras = s2.load(path, name="test")
    assert extras == {"note": "hello"}
    assert (s2.backward_steps, s2.optimizer_steps,
            s2.grad_accum_counter) == (3, 3, 0)
    assert_same_state(s, s2)


VOCAB, L, BATCH = 257, 32, 4


def gpt_stoke(precision, seed):
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                dropout_rate=0.1,
                attention_fn=make_flash_attention(causal=True),
                attention_is_causal=True)
    for block in model.layers:
        block.attention.prob_dropout.rate = 0.0  # flash takes none
    model.init_weights(0)
    return port.Stoke(model, port.StokeOptimizer(torch.optim.AdamW,
                                                 lr=1e-2, weight_decay=1e-4),
                      causal_lm_loss, batch_size_per_device=BATCH,
                      grad_accum=2, device="cpu", precision=precision,
                      grad_clip=port.ClipGradNormConfig(max_norm=0.5),
                      seed=seed)


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_resume_continues_identically(tmp_path, precision):
    """Saved mid-window (5 micro-batches at grad_accum=2) with dropout
    on, a fresh run of another seed resumes bit for bit: the dropout
    generator's state, the accumulated gradients and AdamW's state travel
    in the tag."""
    batches = torch.from_numpy(np.random.default_rng(3).integers(
        0, VOCAB, size=(10, BATCH, L)).astype(np.int64))
    a = gpt_stoke(precision, seed=1)
    for b in batches[:5]:
        a.train_step(b, b)
    path = str(tmp_path / "ckpt")
    a.save(path)
    ref = [float(a.train_step(b, b)) for b in batches[5:]]

    b_ = gpt_stoke(precision, seed=7)
    b_.load(path)
    assert (b_.grad_accum_counter, b_.optimizer_steps) == (1, 2)
    got = [float(b_.train_step(b, b)) for b in batches[5:]]
    assert got == ref
    assert_same_state(a, b_)
    assert b_.optimizer_steps == a.optimizer_steps == 5


def test_mid_window_resume_keeps_gradient_mass(tmp_path):
    r = np.random.default_rng(2)
    W = r.normal(size=(8, 4)).astype(np.float32)
    xs = [r.normal(size=(32, 8)).astype(np.float32) for _ in range(2)]
    ys = [(x @ W).astype(np.float32) for x in xs]

    def half_then_step(s, path=None):
        s.backward(s.loss(s.model(xs[0]), ys[0]))
        if path:
            s.save(path)
        s.backward(s.loss(s.model(xs[1]), ys[1]))
        s.step()
        return s.model_access.w1.detach().clone()

    w_direct = half_then_step(make(grad_accum=2))
    path = str(tmp_path / "ckpt")
    half_then_step(make(grad_accum=2), path=path)
    assert os.path.exists(os.path.join(
        path, checkpoint_tag("stoke", 1), "grad_buf.npz"))

    s = make(grad_accum=2)
    s.load(path)
    assert s.grad_accum_counter == 1
    s.backward(s.loss(s.model(xs[1]), ys[1]))
    s.step()
    assert s.optimizer_steps == 1
    assert torch.equal(s.model_access.w1, w_direct)


def test_boundary_tag_restarts_the_window(tmp_path):
    """A tag without a gradient buffer restarts the window: a live partial
    window is dropped on load."""
    s = train_a_bit(make(grad_accum=2), steps=2)
    path = str(tmp_path / "ckpt")
    s.save(path)
    s2 = make(grad_accum=2)
    x = np.ones((32, 8), np.float32)
    s2.backward(s2.loss(s2.model(x), x[:, :4]))
    s2.load(path)
    assert s2.grad_accum_counter == 0
    assert all(p.grad is None for p in s2.model_access.parameters())


def test_load_name_scoped(tmp_path):
    path = str(tmp_path / "ckpt")
    train_a_bit(make(), steps=1).save(path, name="runA")
    train_a_bit(make(), steps=2).save(path, name="runB")
    s = make()
    s.load(path, name="runA")
    assert s.backward_steps == 1


def test_latest_tag_selection(tmp_path):
    path = str(tmp_path / "ckpt")
    s = train_a_bit(make(), steps=1)
    s.save(path)
    train_a_bit(s, steps=1).save(path)
    s2 = make()
    s2.load(path)
    assert s2.backward_steps == 2
    s3 = make()
    s3.load(path, tag=checkpoint_tag("stoke", 1))
    assert s3.backward_steps == 1


def test_max_to_keep(tmp_path):
    s = make(max_keep=2)
    path = str(tmp_path / "ckpt")
    for _ in range(4):
        train_a_bit(s, steps=1).save(path)
    assert sorted(os.listdir(path)) == [checkpoint_tag("stoke", 3),
                                        checkpoint_tag("stoke", 4)]


def test_auto_save_and_maybe_resume(tmp_path):
    path = str(tmp_path / "auto")

    def mk():
        return make(configs=[CheckpointConfig(
            save_every_n_steps=2, auto_path=path, max_to_keep=1)])

    s = mk()
    assert s.maybe_resume() is False
    train_a_bit(s, steps=5)  # saves at steps 2 and 4
    assert os.listdir(path) == [checkpoint_tag("auto", 4)]
    s2 = mk()
    assert s2.maybe_resume() is True
    assert s2.optimizer_steps == 4
    assert torch.equal(s2.model_access.w1,
                       train_a_bit(make(), steps=4).model_access.w1)


@pytest.mark.parametrize("path_kind", ["train_steps", "train_step_window"])
def test_auto_save_in_window_paths(tmp_path, path_kind):
    """``train_steps`` saves a boundary crossed inside its segment at the
    segment's end; ``train_step_window`` saves at its boundary."""
    path = str(tmp_path / "auto")
    s = make(configs=[CheckpointConfig(save_every_n_steps=2,
                                       auto_path=path)], grad_accum=2)
    r = np.random.default_rng(4)
    x = r.normal(size=(6, 32, 8)).astype(np.float32)
    y = r.normal(size=(6, 32, 4)).astype(np.float32)
    if path_kind == "train_steps":
        s.train_steps(x, y)  # 3 steps: crosses 2, saved at step 3
        assert os.listdir(path) == [checkpoint_tag("auto", 6)]
    else:
        for w in range(3):
            s.train_step_window(x[2 * w:2 * w + 2], y[2 * w:2 * w + 2])
        assert os.listdir(path) == [checkpoint_tag("auto", 4)]
    s2 = make(configs=[CheckpointConfig(save_every_n_steps=2,
                                        auto_path=path)], grad_accum=2)
    assert s2.maybe_resume()
    assert s2.optimizer_steps == (3 if path_kind == "train_steps" else 2)


def test_async_save_roundtrip(tmp_path):
    s = train_a_bit(make(configs=[CheckpointConfig(async_save=True)]),
                    steps=2)
    path = str(tmp_path / "ckpt")
    s.save(path)
    w_at_save = s.model_access.w1.detach().clone()
    train_a_bit(s, steps=2)  # trains on while the save is written
    s.wait_for_checkpoint()
    s2 = make()
    s2.load(path)
    assert s2.optimizer_steps == 2
    assert torch.equal(s2.model_access.w1, w_at_save)


def test_async_save_failure_surfaces(tmp_path, monkeypatch):
    s = train_a_bit(make(configs=[CheckpointConfig(async_save=True)]),
                    steps=1)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(io_ops.np, "savez", boom)
    s.save(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        s.wait_for_checkpoint()
    s.wait_for_checkpoint()  # the failure was reported once


def test_prune_skips_inflight_cleans_stale(tmp_path):
    root = str(tmp_path)
    for step in (1, 2, 3, 5):
        d = os.path.join(root, checkpoint_tag("run", step))
        os.makedirs(d)
        if step not in (2, 5):  # 2 in flight, 5 a failed save's leftover
            with open(os.path.join(d, "meta.json"), "w") as f:
                f.write("{}")
    inflight = os.path.join(root, checkpoint_tag("run", 2))
    _INFLIGHT_TAGS.add(inflight)
    try:
        _prune_old(root, "run", max_to_keep=1)
    finally:
        _INFLIGHT_TAGS.discard(inflight)
    assert sorted(os.listdir(root)) == [checkpoint_tag("run", 2),
                                        checkpoint_tag("run", 3)]


def test_async_save_respects_max_to_keep(tmp_path):
    s = train_a_bit(make(configs=[CheckpointConfig(async_save=True,
                                                   max_to_keep=1)]), steps=1)
    path = str(tmp_path / "ckpt")
    s.save(path)
    train_a_bit(s, steps=1).save(path)
    s.wait_for_checkpoint()
    assert os.listdir(path) == [checkpoint_tag("stoke", 2)]


def test_async_saves_in_flight_together(tmp_path):
    """Twelve async saves in flight at once, the interpreter switching
    threads every microsecond: once they are waited for, exactly the
    newest ``max_to_keep`` tags remain, each loadable, and no writer
    thread is left."""
    import sys

    s = train_a_bit(make(configs=[CheckpointConfig(async_save=True,
                                                   max_to_keep=2)]), steps=1)
    path = str(tmp_path / "ckpt")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(12):
            train_a_bit(s, steps=1).save(path)
        threads = list(io_ops._ASYNC_SAVES)
        s.wait_for_checkpoint()
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert io_ops._ASYNC_SAVES == [] and not _INFLIGHT_TAGS
    assert sorted(os.listdir(path)) == [checkpoint_tag("stoke", 12),
                                        checkpoint_tag("stoke", 13)]
    for step in (12, 13):
        r = make()
        r.load(path, tag=checkpoint_tag("stoke", step))
        assert r.backward_steps == step


def test_failed_async_save_removes_partial_tag(tmp_path, monkeypatch):
    s = train_a_bit(make(configs=[CheckpointConfig(async_save=True)]),
                    steps=1)
    monkeypatch.setattr(io_ops.np, "savez", lambda *a, **k: (
        _ for _ in ()).throw(OSError("disk full")))
    tag_dir = s.save(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError):
        s.wait_for_checkpoint()
    assert not os.path.exists(tag_dir)


class Other(nn.Module):
    def __init__(self, shape=(8, 4)):
        super().__init__()
        self.only = nn.Parameter(torch.zeros(shape))

    def forward(self, x):
        return x @ self.only


@pytest.mark.parametrize("case", ["names", "shape", "optimizer"])
def test_structure_mismatch_rejected(tmp_path, case):
    """A tag that does not fit the live state is refused before anything
    is copied, naming the first array that differs."""
    s = train_a_bit(make())
    path = str(tmp_path / "ckpt")
    s.save(path)
    if case == "names":
        other = port.Stoke(Other(), port.StokeOptimizer(torch.optim.SGD,
                                                        lr=0.1),
                           mse, batch_size_per_device=4, device="cpu")
        match = "'only'"
    elif case == "shape":
        m = MLP()
        m.w2 = nn.Parameter(torch.zeros(32, 5))
        other = port.Stoke(m, port.StokeOptimizer(torch.optim.Adam, lr=0.1),
                           mse, batch_size_per_device=4, device="cpu")
        match = "'w2' is float32\\[32, 4\\]"
    else:
        other = port.Stoke(MLP(), port.StokeOptimizer(
            torch.optim.SGD, lr=0.1, momentum=0.9), mse,
            batch_size_per_device=4, device="cpu")
        train_a_bit(other, steps=1)
        match = "opt_state"
    before = {n: p.clone() for n, p in other.model_access.state_dict().items()}
    with pytest.raises(ValueError, match=match):
        other.load(path)
    for n, p in other.model_access.state_dict().items():
        assert torch.equal(p, before[n])


def test_jax_loader_refuses_a_port_tag(tmp_path):
    """The JAX package's ``Stoke.load`` reads ``leaf_{i}`` by flatten
    order; the port's arrays are named, so it raises rather than load
    them in another order."""
    import jax.numpy as jnp
    import optax

    import stoke_tpu

    path = str(tmp_path / "ckpt")
    train_a_bit(make()).save(path)
    r = np.random.default_rng(5)
    params = {"w1": jnp.asarray(r.normal(size=(8, 32)).astype(np.float32)),
              "w2": jnp.asarray(r.normal(size=(32, 4)).astype(np.float32))}
    js = stoke_tpu.Stoke(
        model=lambda p, x: jnp.maximum(x @ p["w1"], 0) @ p["w2"],
        optimizer=stoke_tpu.StokeOptimizer(
            optimizer=optax.adam, optimizer_kwargs={"learning_rate": 1e-2}),
        loss=lambda o, y: jnp.mean((o - y) ** 2), params=params,
        batch_size_per_device=32, verbose=False)
    with pytest.raises((KeyError, ValueError)):
        js.load(path)
    np.testing.assert_array_equal(np.asarray(js.params["w1"]),
                                  np.asarray(params["w1"]))


def test_later_slice_settings_raise(tmp_path):
    """Offload staging and ``resume`` wait for item 9. The sharded format,
    refused here until item 6b, now writes a tag that loads back exactly
    in both formats' runs (its multi-process cases are in
    ``test_torch_io_distributed.py``)."""
    s = train_a_bit(make(fmt=CheckpointFormat.sharded))
    path = str(tmp_path / "ckpt")
    tag_dir = s.save(path)
    with open(os.path.join(tag_dir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["format"] == "sharded" and meta["world"] == 1
    for fmt in CheckpointFormat:
        s2 = make(fmt=fmt)
        s2.load(path)
        assert_same_state(s, s2)
        assert s2.optimizer_steps == 3
    with pytest.raises(NotImplementedError, match="item 9"):
        make(configs=[CheckpointConfig(async_save=True,
                                       offload_staging=True)])
    with pytest.raises(NotImplementedError, match="item 9"):
        make().resume()
