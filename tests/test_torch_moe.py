"""Port parity: the MoE FFN and expert parallelism
(``stoke_tpu_torch/models/moe.py``, GPT's ``moe_*`` options) against
``stoke_tpu/models/moe.py`` and ``stoke_tpu/models/gpt.py``.

- ``MoEFFN`` outputs and aux loss against the JAX module's apply
  (``train=False`` and ``True``), top-1 and top-2, ample capacity and
  overflow, fp32 at rtol 2e-5 / atol 2e-6; the choice-major priority
  case of ``tests/test_moe.py:338-390``;
- GPT-tiny-MoE logits against the JAX apply on converted weights;
- the validation messages; router noise reaching the routers;
- the collapse / rebalance pair through ``Stoke``
  (``tests/test_moe.py:259-295``); a save holds no aux loss;
- ``ServingEngine`` refusing a MoE GPT; remat with router noise bit for
  bit with no remat;
- the experts split over virtual ranks (each rank's experts computed, the
  outputs gathered by hand) against the unsplit FFN, forward and
  gradients.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoke_tpu.models import GPT as JaxGPT
from stoke_tpu.models import MoEFFN as JaxMoEFFN
from stoke_tpu.utils import init_module
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch.configs import ServeConfig
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.models import (
    GPT,
    MoEFFN,
    MoETransformerBlock,
    causal_lm_loss,
    moe_expert_parallel_rules,
)
from stoke_tpu_torch.models.gpt import MOE_KV_CACHE
from stoke_tpu_torch.parallel import ModelGroup, shard_module

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its small tensors gain nothing
    from more, and beside the suite's other workers each spare thread
    spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, L, H, FF, E = 2, 8, 16, 32, 4
TOL = dict(rtol=2e-5, atol=2e-6)


def _port_ffn(params, **kw) -> MoEFFN:
    m = MoEFFN(H, FF, kw.pop("num_experts", E), **kw)
    m.load_state_dict({
        "router.weight": torch.from_numpy(
            np.ascontiguousarray(np.asarray(params["router"]["kernel"]).T)),
        "w_in": torch.from_numpy(np.asarray(params["w_in"])),
        "w_out": torch.from_numpy(np.asarray(params["w_out"]))})
    return m


CASES = {"top1": dict(capacity_factor=4.0, top_k=1),
         "top2": dict(capacity_factor=8.0, top_k=2),
         "top1_overflow": dict(capacity_factor=0.25, top_k=1),
         "top2_overflow": dict(capacity_factor=0.5, top_k=2),
         "default": {}}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_jax(case, train):
    kw = CASES[case]
    jm = JaxMoEFFN(hidden=H, ff=FF, num_experts=E, **kw)
    x = np.random.default_rng(42).normal(size=(B, L, H)).astype(np.float32)
    v = init_module(jm, jax.random.PRNGKey(0), x, train=False)
    ref, state = jm.apply(v, x, train=train, mutable=["losses"])
    aux = float(jax.tree_util.tree_leaves(state["losses"])[0])
    m = _port_ffn(v["params"], **kw).train(train)
    out = m(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(float(m.aux_loss), aux, **TOL)
    assert float(m.aux_loss) >= 1.0 - 1e-5
    if "overflow" in case:  # some tokens dropped, as the JAX test shows
        flat = out.detach().numpy().reshape(-1, H)
        assert (np.abs(flat).max(-1) < 1e-7).sum() > 0


def test_top2_choice_major_priority_as_jax():
    """First choices claim capacity before second choices: with room for
    the first-choice load only, every second choice overflows; with
    ample capacity they come back (the JAX case's router kernel)."""
    E2 = 2
    x = np.zeros((1, 4, H), np.float32)
    for t in range(4):
        x[0, t, t] = 1.0
    jm = JaxMoEFFN(hidden=H, ff=FF, num_experts=E2, capacity_factor=0.5,
                   top_k=2)
    v = init_module(jm, jax.random.PRNGKey(0), x, train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    kernel = np.zeros((H, E2), np.float32)
    kernel[0] = kernel[1] = [1.0, 2.0]
    kernel[2] = kernel[3] = [2.0, 1.0]
    params["router"]["kernel"] = kernel
    for cf in (0.5, 4.0):
        ref = JaxMoEFFN(hidden=H, ff=FF, num_experts=E2, capacity_factor=cf,
                        top_k=2).apply({"params": params}, x, train=False)
        m = _port_ffn(params, num_experts=E2, capacity_factor=cf, top_k=2)
        out = m(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    # the tight case keeps one expert's contribution a token
    tight = _port_ffn(params, num_experts=E2, capacity_factor=0.5, top_k=2)
    slot, gates = tight.route(torch.from_numpy(x))
    assert (gates > 0).sum().item() == 4
    assert int(slot.max()) == E2 * 1 * tight.capacity(4)


def _gpt_pair(**kw):
    jm = JaxGPT(vocab_size=32, size_name="tiny", max_len=32,
                dropout_rate=0.0, moe_num_experts=E, moe_every=2, **kw)
    seq = np.random.default_rng(3).integers(1, 32, size=(2, 16)).astype(
        np.int32)
    v = init_module(jm, jax.random.PRNGKey(0), seq, train=False)
    pm = GPT(vocab_size=32, size_name="tiny", max_len=32, dropout_rate=0.0,
             moe_num_experts=E, moe_every=2, **kw)
    pm.load_state_dict(gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, v["params"])))
    return jm, v, pm, seq


@pytest.mark.parametrize("top_k", [1, 2])
def test_gpt_tiny_moe_logits_match_jax(top_k):
    jm, v, pm, seq = _gpt_pair(moe_capacity_factor=1.25, moe_top_k=top_k)
    assert isinstance(pm.layers[1], MoETransformerBlock)
    assert not isinstance(pm.layers[0], MoETransformerBlock)
    ref = np.asarray(jm.apply(v, seq, train=False))
    got = pm.eval()(torch.from_numpy(seq.astype(np.int64)))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(moe_every=0), "moe_every must be"),
    (dict(moe_every=3), "selects no layer"),
])
def test_gpt_moe_validation_as_jax(kw, match):
    seq = np.ones((1, 8), np.int32)
    with pytest.raises(ValueError, match=match) as theirs:
        init_module(JaxGPT(vocab_size=16, size_name="tiny",
                           moe_num_experts=2, **kw),
                    jax.random.PRNGKey(0), seq, train=False)
    with pytest.raises(ValueError) as mine:
        GPT(vocab_size=16, size_name="tiny", moe_num_experts=2, **kw)
    assert str(mine.value) == str(theirs.value)


def test_top_k_validation_as_jax():
    with pytest.raises(ValueError) as theirs:
        JaxMoEFFN(hidden=H, ff=FF, num_experts=2, top_k=3).apply(
            {"params": {}}, jnp.zeros((1, 4, H)), train=False)
    with pytest.raises(ValueError) as mine:
        MoEFFN(H, FF, 2, top_k=3)(torch.zeros(1, 4, H))
    assert str(mine.value) == str(theirs.value)


def test_router_noise_reaches_the_routers():
    model = GPT(vocab_size=32, size_name="tiny", max_len=32,
                dropout_rate=0.0, moe_num_experts=4, moe_capacity_factor=1.0,
                moe_router_noise=5.0).train()
    model.init_weights(0)
    seq = torch.from_numpy(np.random.default_rng(0).integers(
        1, 32, size=(2, 16)))
    outs = []
    for seed in (1, 2):
        model.layers[1].moe.generator = torch.Generator().manual_seed(seed)
        outs.append(model(seq).detach())
    assert not torch.allclose(outs[0], outs[1])
    model.eval()
    assert torch.equal(model(seq), model(seq))


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.moe = MoEFFN(H, FF, E, capacity_factor=4.0)

    def forward(self, x):
        return self.moe(x)


def _fractions(s, x) -> np.ndarray:
    w = s.model_access.moe.router.weight.detach().numpy()
    eidx = (x.reshape(-1, H) @ w.T).argmax(-1)
    return np.bincount(eidx, minlength=E) / len(eidx)


def _collapsed_stoke(aux_loss_weight):
    """The JAX test's run: the router surgically collapsed onto expert 0
    (positive inputs, column 0 dominant), a task loss indifferent to
    routing, Adam at 0.05."""
    r = np.random.default_rng(3)
    x = np.abs(r.normal(size=(4, L, H))).astype(np.float32)
    kernel = (0.3 * r.normal(size=(H, E))).astype(np.float32)
    kernel[:, 0] = 1.0
    net = _Net()
    with torch.no_grad():
        net.moe.router.weight.copy_(torch.from_numpy(kernel.T))
    s = Stoke(net, StokeOptimizer(torch.optim.Adam, lr=0.05),
              lambda out, y: 0.0 * out.sum(), batch_size_per_device=4,
              device="cpu", aux_loss_weight=aux_loss_weight)
    return s, x


@pytest.mark.parametrize("weight", [0.0, 1.0])
def test_aux_loss_rebalances_a_collapsed_router(weight):
    s, x = _collapsed_stoke(weight)
    assert _fractions(s, x).max() == 1.0
    assert s.aux_losses is not None
    y = torch.zeros(4)
    for _ in range(50):
        s.train_step(torch.from_numpy(x), y)
    frac = _fractions(s, x)
    aux = float(s.aux_losses["moe"]["aux_loss"])
    if weight == 0.0:
        assert frac.max() == 1.0
    else:
        assert frac.max() < 0.9, frac
        assert aux < 2.0, aux


def test_a_save_holds_no_aux_loss(tmp_path):
    s, x = _collapsed_stoke(1.0)
    for _ in range(3):
        s.train_step(torch.from_numpy(x), torch.zeros(4))
    assert "aux_loss" not in str(list(s.model_access.state_dict()))
    tag = s.save(str(tmp_path / "ckpt"))
    data = np.load(os.path.join(tag, "variables.npz"))
    assert sorted(data.files) == sorted(s.model_access.state_dict())
    s2, _ = _collapsed_stoke(1.0)
    s2.load(str(tmp_path / "ckpt"))
    assert s2.optimizer_steps == 3
    assert torch.equal(s2.model_access.moe.router.weight,
                       s.model_access.moe.router.weight)
    s2.train_step(torch.from_numpy(x), torch.zeros(4))
    assert s2.aux_losses["moe"]["aux_loss"] > 0


def test_aux_losses_none_without_moe():
    model = GPT(vocab_size=32, size_name="tiny", max_len=32)
    s = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.1),
              causal_lm_loss, batch_size_per_device=2, device="cpu")
    assert s.aux_losses is None


def test_serving_engine_refuses_a_moe_gpt():
    from stoke_tpu_torch.serving import ServingEngine

    model = GPT(vocab_size=32, size_name="tiny", max_len=64,
                moe_num_experts=4)
    with pytest.raises(NotImplementedError) as e:
        ServingEngine(model, model.state_dict(), ServeConfig(
            max_seqs=2, kv_block_size=16, max_seq_len=64), device="cpu")
    assert str(e.value) == MOE_KV_CACHE
    with pytest.raises(NotImplementedError, match="dense FFN blocks only"):
        model(torch.ones(1, 4, dtype=torch.long), kv_cache=object())


def _noisy_run(remat: bool):
    model = GPT(vocab_size=32, size_name="tiny", max_len=32,
                dropout_rate=0.1, moe_num_experts=4, moe_every=1,
                moe_router_noise=1.0, moe_top_k=2, remat=remat)
    model.init_weights(0)
    s = Stoke(model, StokeOptimizer(torch.optim.AdamW, lr=1e-2),
              causal_lm_loss, batch_size_per_device=2, device="cpu", seed=3)
    r = np.random.default_rng(0)
    losses = []
    for _ in range(3):
        b = torch.from_numpy(r.integers(0, 32, size=(2, 16)))
        losses.append(float(s.train_step(b, b)))
    aux = [float(m["moe"]["aux_loss"]) for m in s.aux_losses.values()]
    return losses, aux, s.model_access.state_dict()


def test_remat_with_router_noise_is_bit_for_bit():
    """Each block recomputed in backward replays its forward's router
    noise (and dropout masks): the losses, aux losses and parameters of
    a run equal those without remat bit for bit."""
    a, b = _noisy_run(False), _noisy_run(True)
    assert a[0] == b[0] and a[1] == b[1]
    for n, t in a[2].items():
        assert torch.equal(b[2][n], t), n


@pytest.mark.parametrize("X", [1, 2, 4])
def test_virtual_expert_ranks_match_the_unsplit_ffn(X):
    """The experts split over X virtual ranks by the port's own cut
    (``moe_expert_parallel_rules``): each rank's experts on its slots,
    the outputs gathered by hand, combined; forward and every gradient
    against the unsplit FFN."""
    torch.manual_seed(0)
    whole = MoEFFN(H, FF, E, capacity_factor=1.0, top_k=2)
    x = torch.randn(B, L, H, requires_grad=True)
    ref = whole(x)
    ref.pow(2).sum().backward()
    ranks = []
    for r in range(X):
        m = MoEFFN(H, FF, E, capacity_factor=1.0, top_k=2)
        m.load_state_dict(whole.state_dict())
        tp = shard_module(m, moe_expert_parallel_rules(),
                          ModelGroup(None, X, r, "expert"))
        assert m.local_experts == E // X and set(tp.cuts) == {"w_in",
                                                             "w_out"}
        ranks.append(m)
    xs = x.detach().clone().requires_grad_()
    slot, gates = ranks[0].route(xs)
    expert_in = ranks[0].dispatch(xs, slot)
    n = E // X
    outs = [m.experts(expert_in[r * n:(r + 1) * n])
            for r, m in enumerate(ranks)]
    got = MoEFFN.combine(torch.cat(outs), slot, gates)
    got.pow(2).sum().backward()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(xs.grad, x.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ranks[0].router.weight.grad,
                               whole.router.weight.grad, rtol=1e-5,
                               atol=1e-6)
    for name in ("w_in", "w_out"):
        g = torch.cat([getattr(m, name).grad for m in ranks])
        torch.testing.assert_close(g, getattr(whole, name).grad, rtol=1e-5,
                                   atol=1e-6)
