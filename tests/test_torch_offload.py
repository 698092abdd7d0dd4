"""The port's offload tiers against ``tests/test_offload_disk.py``,
``tests/test_facade.py:660-672``, ``tests/test_distributed.py:112-150``
and ``tests/test_status.py:187-207``.

The disk tier's store round-trips fp32, bfloat16 and float16 by their
bits and spares the protected tensors; a run with the disk tier equals
the run without it bit for bit, at ``grad_accum`` 1 and 2. The pinned
host tier has no host to offload to on the CPU (``fallback_to_device``
warns, or the status layer refuses), so its streaming is held here by
driving :class:`~stoke_tpu_torch.offload.HostOptimizerState` over CPU
tensors (several leaf groups, fp32, bf16 and fp16): bit for bit the
optimizer's own step. Parameter offload under fsdp is driven the same way
(:meth:`Ladder.offload_params` over CPU tensors in a one-process group):
bit for bit fsdp without it, and dp at rel 1e-4 (the JAX test's
tolerance). Their pinned, captured forms run on the card
(``chip_smoke.offload``). The status rules are the JAX package's.
"""

import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stoke_tpu_torch import (
    OffloadDiskConfig,
    OffloadOptimizerConfig,
    Stoke,
    StokeOptimizer,
    StokeValidationError,
    offload,
)
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.ops import make_flash_attention
from stoke_tpu_torch.status import StokeStatus

pytestmark = pytest.mark.torch_port

VOCAB, B, L = 97, 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its tiny models gain nothing
    from more, and beside the suite's other workers each spare thread
    spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt():
    m = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
            dropout_rate=0.0, attention_fn=make_flash_attention(causal=True),
            attention_is_causal=True)
    for block in m.layers:
        block.attention.prob_dropout.rate = 0.0
    m.init_weights(0)
    return m


def _stoke(configs=(), precision=None, grad_accum=None):
    return Stoke(_gpt(), StokeOptimizer(torch.optim.AdamW, lr=3e-3),
                 causal_lm_loss, batch_size_per_device=B, device="cpu",
                 precision=precision, grad_accum=grad_accum,
                 configs=list(configs))


def _tokens(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, VOCAB, (n, B, L), generator=g)


def _run(s, tokens, windows=0):
    """Four-call micro-steps over ``tokens``, then ``windows`` windows of
    ``grad_accum`` micro-batches through ``train_steps``."""
    k = s.grad_accum
    losses = []
    eager = tokens[:len(tokens) - windows * k]
    for t in eager:
        loss = s.loss(s.model(t), t)
        s.backward(loss)
        s.step()
        losses.append(float(loss))
    if windows:
        rest = tokens[len(eager):]
        losses += [float(v) for v in s.train_steps(rest, rest).reshape(-1)]
    return losses


def _same(a, b):
    for (n, p), q in zip(a.model_access.named_parameters(),
                         b.model_access.parameters()):
        assert torch.equal(p, q), n


# --------------------------------------------------------------------------- #
# the disk tier's store
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_store_roundtrip(tmp_path, dtype):
    g = torch.Generator().manual_seed(1)
    tree = {"m": torch.randn(7, 5, generator=g).to(dtype),
            "v": [torch.randn(3, generator=g).to(dtype),
                  torch.tensor(2.5).to(dtype)],
            "count": 4}
    want = {"m": tree["m"].clone(), "v": [t.clone() for t in tree["v"]]}
    store = offload.DiskOptimizerStore(str(tmp_path / "spill"))
    assert not store.spilled
    store.store(tree)
    assert store.spilled and len(store.files()) == 3
    assert all(os.path.exists(f) for f in store.files())
    # the spilled tensors' memory is freed in place
    assert tree["m"].untyped_storage().size() == 0
    got = store.load()
    assert got["count"] == 4
    for a, b in ((got["m"], want["m"]), *zip(got["v"], want["v"])):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.equal(a.view(-1).view(torch.uint8)
                           if a.dim() else a.reshape(1).view(torch.uint8),
                           b.view(-1).view(torch.uint8)
                           if b.dim() else b.reshape(1).view(torch.uint8))
    store.close()
    assert not os.path.exists(str(tmp_path / "spill"))


def test_store_protects_aliased_params(tmp_path):
    param = torch.ones(4, 4)
    store = offload.DiskOptimizerStore(str(tmp_path / "spill"))
    store.store({"alias": param, "own": torch.zeros(3)}, protect=[param])
    assert param.untyped_storage().size() == param.numel() * 4
    assert torch.equal(param, torch.ones(4, 4))
    assert torch.equal(store.load()["alias"], torch.ones(4, 4))
    with pytest.raises(RuntimeError, match="before store"):
        offload.DiskOptimizerStore(str(tmp_path / "other")).load()


def test_reclaim_stale_spills(tmp_path):
    base = tmp_path / "proc0"
    for name, pid in (("dead", 2**22 + 12345), ("alive", os.getpid())):
        (base / name).mkdir(parents=True)
        (base / name / "pid").write_text(str(pid))
    (base / "nopid").mkdir()
    offload.reclaim_stale_spills(str(base))
    assert sorted(os.listdir(base)) == ["alive", "nopid"]


# --------------------------------------------------------------------------- #
# the disk tier through the facade
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_disk_offload_matches_device(tmp_path, grad_accum):
    """Spilled after each update and loaded back before the next, the
    state gives the parameters of the run without offload bit for bit
    (eager steps, then windows, which this tier runs uncaptured)."""
    tokens = _tokens(6 * grad_accum)
    ref = _stoke(grad_accum=grad_accum)
    disk = _stoke([OffloadDiskConfig(path=str(tmp_path / "nvme"))],
                  grad_accum=grad_accum)
    assert _run(disk, tokens, windows=2) == _run(ref, tokens, windows=2)
    _same(disk, ref)
    store = disk._engine.disk_store
    assert store.spilled and store.files()
    assert all(os.path.exists(f) for f in store.files())
    assert store.directory.startswith(str(tmp_path / "nvme" / "proc0"))
    # between steps the optimizer's moments hold no memory
    for p in disk.model_access.parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            assert disk.optimizer.state[p][key].untyped_storage().size() == 0
    # a checkpoint reads the spilled state back
    tag = disk.save(str(tmp_path / "ck"))
    back = _stoke()
    back.load(str(tmp_path / "ck"), tag=os.path.basename(tag))
    for p, q in zip(ref.model_access.parameters(),
                    back.model_access.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(ref.optimizer.state[p][key],
                               back.optimizer.state[q][key])


#: the tolerance against the JAX facade's trajectory; parameters also
#: get JAX_PARAM_ATOL: the two AdamW updates round in another order, a few
#: fp32 ulps (~3e-7 seen) on entries near zero
JAX_RTOL, JAX_PARAM_ATOL = 1e-5, 1e-6


def _regression(n, seed=3):
    """Two-layer tanh regression weights and batches, numpy."""
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(8, 16)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(16, 4)) * 0.3).astype(np.float32)
    batches = []
    for _ in range(n):
        x = rng.normal(size=(4, 8)).astype(np.float32)
        batches.append((x, np.sin(x[:, :4]).astype(np.float32)))
    return (w1, w2), batches


def _four_call(s, batches, wrap):
    losses = []
    for x, y in batches:
        loss = s.loss(s.model(wrap(x)), wrap(y))
        s.backward(loss)
        s.step()
        losses.append(float(np.asarray(loss)))
    return losses


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_disk_offload_matches_jax(tmp_path, grad_accum):
    """Both facades with ``OffloadDiskConfig``, on the same numpy weights
    and batches (AdamW, the spilled state): losses at rel 1e-5, and
    parameters at rel 1e-5 over an absolute floor of 1e-6."""
    import jax.numpy as jnp
    import optax

    import stoke_tpu

    (w1, w2), batches = _regression(4 * grad_accum)
    js = stoke_tpu.Stoke(
        model=lambda p, x: jnp.tanh(x @ p["w1"]) @ p["w2"],
        optimizer=stoke_tpu.StokeOptimizer(
            optimizer=optax.adamw,
            optimizer_kwargs={"learning_rate": 1e-2, "b1": 0.9,
                              "b2": 0.999, "eps": 1e-8,
                              "weight_decay": 1e-4}),
        loss=lambda o, y: ((o - y) ** 2).mean(),
        params={"w1": w1, "w2": w2}, batch_size_per_device=4,
        grad_accum=grad_accum, device="cpu",
        configs=[stoke_tpu.OffloadDiskConfig(path=str(tmp_path / "jax"))],
        verbose=False)
    jax_losses = _four_call(js, batches, lambda a: a)

    model = torch.nn.Sequential(torch.nn.Linear(8, 16, bias=False),
                                torch.nn.Tanh(),
                                torch.nn.Linear(16, 4, bias=False))
    with torch.no_grad():
        model[0].weight.copy_(torch.from_numpy(w1.T))
        model[2].weight.copy_(torch.from_numpy(w2.T))
    ps = Stoke(model, StokeOptimizer(torch.optim.AdamW, lr=1e-2,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=1e-4),
               lambda o, y: ((o - y) ** 2).mean(), batch_size_per_device=4,
               device="cpu", grad_accum=grad_accum,
               configs=[OffloadDiskConfig(path=str(tmp_path / "port"))])
    losses = _four_call(ps, batches, torch.from_numpy)
    assert ps._engine.disk_store.spilled
    assert ps.optimizer_steps == 4
    np.testing.assert_allclose(losses, jax_losses, rtol=JAX_RTOL)
    for name, mod in (("w1", model[0]), ("w2", model[2])):
        np.testing.assert_allclose(mod.weight.detach().numpy().T,
                                   np.asarray(js.params[name]),
                                   rtol=JAX_RTOL, atol=JAX_PARAM_ATOL)


def test_disk_offload_default_path_is_cleaned(tmp_path):
    s = _stoke([OffloadDiskConfig()])
    _run(s, _tokens(2))
    spill = s._engine.disk_store.directory
    assert os.path.isdir(spill)
    s._engine.disk_store.close()
    assert not os.path.exists(os.path.dirname(spill))


# --------------------------------------------------------------------------- #
# the host tier
# --------------------------------------------------------------------------- #


def test_offload_optimizer_fallback_trains():
    """On the CPU there is no host tier: the config warns and the run
    trains with its state where it is (the JAX fallback)."""
    with pytest.warns(UserWarning, match="host offload unsupported"):
        s = _stoke([OffloadOptimizerConfig()])
    assert s._engine.host_state is None
    _run(s, _tokens(5))
    assert s.optimizer_steps == 5


@pytest.mark.parametrize("precision", [None, "bf16", "fp16"])
def test_host_tier_streaming_is_the_optimizers_step(monkeypatch, tmp_path,
                                                    precision):
    """The host tier's group-by-group step through one bounded buffer
    (here over CPU tensors, unpinned) gives the parameters and the AdamW
    state of the plain step bit for bit, at grad_accum 2, eager and in
    windows; the buffer is the largest group's state."""
    monkeypatch.setattr(offload, "GROUP_MIN_ELEMS", 4096)
    tokens = _tokens(8)
    ref = _stoke(precision=precision, grad_accum=2)
    host = _stoke(precision=precision, grad_accum=2)
    hs = offload.HostOptimizerState(host._engine.optimizer,
                                    torch.device("cpu"))
    host._engine.host_state = hs
    assert len(hs.groups) > 2
    assert _run(host, tokens, windows=2) == _run(ref, tokens, windows=2)
    _same(host, ref)
    hosted = {id(t) for t in hs.host_tensors}
    for p, q in zip(ref.model_access.parameters(),
                    host.model_access.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert id(host.optimizer.state[q][key]) in hosted
            assert torch.equal(ref.optimizer.state[p][key],
                               host.optimizer.state[q][key])
    largest = max(sum(p.numel() for p in g) for g in hs.groups)
    per = 2 if precision == "fp16" else 1  # fp16 keeps the skip's copy
    assert hs.buffer_bytes == per * 2 * 4 * largest
    assert host.skipped_optimizer_steps == ref.skipped_optimizer_steps
    # a checkpoint reads the host state and a fresh host-tier run resumes
    tag = host.save(str(tmp_path / "ck"))
    back = _stoke(precision=precision, grad_accum=2)
    back._engine.host_state = offload.HostOptimizerState(
        back._engine.optimizer, torch.device("cpu"))
    back.load(str(tmp_path / "ck"), tag=os.path.basename(tag))
    more = _tokens(4, seed=1)
    assert _run(back, more) == _run(ref, more)
    _same(back, ref)


# --------------------------------------------------------------------------- #
# the status rules, letter for letter the JAX package's
# --------------------------------------------------------------------------- #


def _verdicts(kw):
    from stoke_tpu import StokeStatus as JaxStatus
    from stoke_tpu import StokeValidationError as JaxError
    import stoke_tpu.configs as jc

    def port_cfg(c):
        import stoke_tpu_torch.configs as pc

        return getattr(pc, type(c).__name__)(**vars(c))

    jax_cfgs = [getattr(jc, n)(**a) for n, a in kw.pop("configs")]
    out = []
    for make, err in ((lambda: JaxStatus(configs=jax_cfgs, **kw), JaxError),
                      (lambda: StokeStatus(
                          configs=[port_cfg(c) for c in jax_cfgs],
                          **{**kw, "device": {"tpu": "cuda"}.get(
                              kw.get("device", "cpu"),
                              kw.get("device", "cpu"))}),
                       StokeValidationError)):
        try:
            make()
            out.append("ok")
        except err as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("case", ["cpu_no_fallback", "cpu_fallback",
                                  "card_no_fallback", "params_no_fsdp",
                                  "disk_and_host"])
def test_offload_status_rules_match_jax(case):
    kw = dict(batch_size_per_device=8, **{
        "cpu_no_fallback": dict(configs=[
            ("OffloadOptimizerConfig", dict(fallback_to_device=False))]),
        "cpu_fallback": dict(configs=[("OffloadOptimizerConfig", {})]),
        "card_no_fallback": dict(device="tpu", configs=[
            ("OffloadOptimizerConfig", dict(fallback_to_device=False))]),
        "params_no_fsdp": dict(distributed="dp", configs=[
            ("OffloadParamsConfig", {})]),
        "disk_and_host": dict(configs=[("OffloadDiskConfig", {}),
                                       ("OffloadOptimizerConfig", {})]),
    }[case])
    theirs, ours = _verdicts(kw)
    assert ours == theirs
    assert (ours == "ok") == (case in ("cpu_fallback", "card_no_fallback"))
    if case == "params_no_fsdp":
        assert "requires fsdp=True" in ours
    if case == "disk_and_host":
        assert "mutually exclusive" in ours


# --------------------------------------------------------------------------- #
# parameter offload under fsdp (a one-process group)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def one_process():
    """The process group the first ``distributed="dp"`` Stoke makes, torn
    down after the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _fsdp_stoke(tier, configs=()):
    from stoke_tpu_torch.configs import FSDPConfig

    flags = dict(fsdp=True) if tier == "fsdp" else {}
    return Stoke(_gpt(), StokeOptimizer(torch.optim.AdamW, lr=3e-3),
                 causal_lm_loss, batch_size_per_device=B, device="cpu",
                 distributed="dp", grad_accum=2,
                 configs=[FSDPConfig(min_weight_size=1), *configs], **flags)


def test_param_offload_fsdp_trains(one_process, tmp_path):
    """fsdp's slices in host memory between steps: the run equals fsdp
    without offload bit for bit and dp at rel 1e-4; between steps the
    slices' device buffers and the parameters hold no storage; a
    checkpoint round-trips through the offloaded slices."""
    from stoke_tpu_torch.configs import OffloadParamsConfig

    tokens = _tokens(8)
    with pytest.warns(UserWarning, match="parameter host offload"):
        fallback = _fsdp_stoke("fsdp", [OffloadParamsConfig()])
    assert fallback._ladder.host_slices == []
    dp, plain, off = (_fsdp_stoke(t) for t in ("dp", "fsdp", "fsdp"))
    off._ladder.offload_params()
    hosts = off._ladder.host_slices
    assert hosts and not off._ladder._own_resident
    want = _run(plain, tokens, windows=2)
    assert _run(off, tokens, windows=2) == want
    np.testing.assert_allclose(_run(dp, tokens, windows=2), want, rtol=1e-4)
    for b in off._ladder._freed:
        assert b.own.untyped_storage().nbytes() == 0
        assert all(p.untyped_storage().nbytes() == 0 for p in b.leaves)
    with plain._whole_params(), off._whole_params(), dp._whole_params():
        for p, q, r in zip(plain.model_access.parameters(),
                           off.model_access.parameters(),
                           dp.model_access.parameters()):
            assert torch.equal(p, q)
            # (no numpy views: they would pin fsdp's storage)
            torch.testing.assert_close(q, r, rtol=1e-4, atol=1e-6)
    assert not off._ladder._own_resident  # whole() spilled them again
    path = str(tmp_path / "ck")
    off.save(path)
    back = _fsdp_stoke("fsdp")
    back._ladder.offload_params()
    back.load(path)
    with back._whole_params(), off._whole_params():
        for p, q in zip(back.model_access.parameters(),
                        off.model_access.parameters()):
            assert torch.equal(p, q)
    assert _run(back, tokens[:2]) == _run(off, tokens[:2])
