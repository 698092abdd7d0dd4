"""Port parity: the status layer and the facade's guards.

The one-device rows of ``tests/test_status.py`` are the spec: the same
flags are legal or illegal in both packages, typo'd enums list the valid
options, and configs dedupe by class name. Flags of later slices pass the
same legality rules, then raise ``NotImplementedError`` naming their
ROADMAP item. The facade's guards follow ``tests/test_facade.py``.
"""

import numpy as np
import pytest
import torch
from torch import nn

from stoke_tpu import StokeValidationError as JaxValidationError
from stoke_tpu.status import StokeStatus as JaxStatus
from stoke_tpu_torch import (
    ArrayDataset,
    ClipGradConfig,
    ClipGradNormConfig,
    PrecisionConfig,
    Stoke,
    StokeDataLoader,
    StokeOptimizer,
    StokeValidationError,
)
from stoke_tpu_torch.configs import (
    CheckpointConfig,
    CheckpointFormat,
    DistributedOptions,
    MeshConfig,
    PrecisionOptions,
    ServeConfig,
)
from stoke_tpu_torch.status import StokeStatus

pytestmark = pytest.mark.torch_port

LATER = "not ported yet: ROADMAP Queue 1 item"

# (kwargs, outcome in the port); "ok", "invalid" (StokeValidationError in
# both packages) or "later" (legal in the JAX package, a later slice here)
MATRIX = [
    (dict(batch_size_per_device=8), "ok"),
    (dict(batch_size_per_device=0), "invalid"),
    (dict(batch_size_per_device=8, grad_accum=0), "invalid"),
    (dict(batch_size_per_device=8, grad_accum=4), "ok"),
    (dict(batch_size_per_device=8, oss=True), "invalid"),
    (dict(batch_size_per_device=8, sddp=True), "invalid"),
    (dict(batch_size_per_device=8, fsdp=True), "invalid"),
    (dict(batch_size_per_device=8, distributed="dp", sddp=True), "invalid"),
    (dict(batch_size_per_device=8, distributed="dp", fsdp=True, oss=True),
     "invalid"),
    (dict(batch_size_per_device=8, precision="bf16"), "ok"),
    (dict(batch_size_per_device=8, precision="fp16"), "ok"),
    (dict(batch_size_per_device=8, distributed="dp"), "ok"),
    (dict(batch_size_per_device=8, distributed="ddp", oss=True), "ok"),
    # a (data, model) mesh runs since item 8b; three axes wait (8e)
    (dict(batch_size_per_device=8, distributed="dp",
          configs=[MeshConfig(axes=("data", "model", "expert"))]), "later"),
    (dict(batch_size_per_device=8, grad_clip=ClipGradConfig(clip_value=0.0)),
     "invalid"),
    (dict(batch_size_per_device=8,
          grad_clip=ClipGradNormConfig(max_norm=1.0, norm_type=float("inf"))),
     "ok"),
    (dict(batch_size_per_device=8, grad_clip=ClipGradNormConfig(max_norm=-1)),
     "invalid"),
    (dict(batch_size_per_device=8, configs=[PrecisionConfig(num_losses=2)]),
     "invalid"),
    # the (data, seq) mesh runs since item 8a; the tiers under it wait
    (dict(batch_size_per_device=8, distributed="dp",
          configs=[MeshConfig(axes=("data", "seq"))]), "ok"),
    (dict(batch_size_per_device=8, distributed="dp", oss=True,
          configs=[MeshConfig(axes=("data", "seq"))]), "later"),
    (dict(batch_size_per_device=8, distributed="dp",
          configs=[MeshConfig(axes=("data", "model"))]), "ok"),
]


def _jax_kwargs(kwargs):
    """The same flags for the JAX package (its own config classes)."""
    from stoke_tpu import configs as jc

    out = dict(kwargs)
    clip = out.get("grad_clip")
    if clip is not None:
        out["grad_clip"] = getattr(jc, type(clip).__name__)(**vars(clip))
    out["configs"] = [getattr(jc, type(c).__name__)(**vars(c))
                      for c in out.get("configs", ())]
    return out


@pytest.mark.parametrize("kwargs,outcome", MATRIX)
def test_combination_matrix_one_device(kwargs, outcome):
    if outcome == "invalid":
        with pytest.raises(JaxValidationError):
            JaxStatus(**_jax_kwargs(kwargs))
        with pytest.raises(StokeValidationError):
            StokeStatus(**kwargs)
        return
    JaxStatus(**_jax_kwargs(kwargs))
    if outcome == "later":
        with pytest.raises(NotImplementedError, match=LATER):
            StokeStatus(**kwargs)
    else:
        StokeStatus(**kwargs)


@pytest.mark.parametrize("flag,value", [("distributed", "nccl"),
                                        ("precision", "int8"),
                                        ("device", "tpu"),
                                        ("device", "gpu")])
def test_typo_enum_lists_valid_options(flag, value):
    with pytest.raises(StokeValidationError, match="valid: ") as e:
        StokeStatus(batch_size_per_device=4, **{flag: value})
    assert repr(value) in str(e.value)


def test_reference_aliases():
    for alias in ("amp", "apex_O1", "apex_O2", "deepspeed", "bf16",
                  "bfloat16"):
        st = StokeStatus(batch_size_per_device=4, precision=alias)
        assert st.precision is PrecisionOptions.bf16, alias
    for alias in ("fp32", "full", None):
        st = StokeStatus(batch_size_per_device=4, precision=alias)
        assert st.precision is PrecisionOptions.full
    for alias in ("ddp", "horovod", "deepspeed", "xla", "dp"):
        st = StokeStatus(batch_size_per_device=4, distributed=alias)
        assert st.distributed is DistributedOptions.dp, alias
    assert DistributedOptions("dp") is DistributedOptions.dp


def test_config_dedupe_warns_and_keeps_the_last():
    a, b = PrecisionConfig(output_dtype="float32"), PrecisionConfig(
        output_dtype="bfloat16")
    with pytest.warns(UserWarning, match="Duplicate config PrecisionConfig"):
        st = StokeStatus(batch_size_per_device=4, configs=[a, b])
    assert st.precision_config is b


def test_unknown_and_later_configs():
    class NotAConfig:
        pass

    with pytest.raises(StokeValidationError, match="Unrecognized"):
        StokeStatus(batch_size_per_device=4, configs=[NotAConfig()])
    # ServeConfig and CheckpointConfig are taken, the sharded format and
    # offload staging too (items 6b and 9, refused here before they were
    # ported)
    serve = ServeConfig()
    st = StokeStatus(batch_size_per_device=4, configs=[serve])
    assert st.serve_config is serve
    sharded = CheckpointConfig(format=CheckpointFormat.sharded)
    st = StokeStatus(batch_size_per_device=4, configs=[sharded])
    assert st.checkpoint_config is sharded
    staged = CheckpointConfig(async_save=True, offload_staging=True)
    st = StokeStatus(batch_size_per_device=4, configs=[staged])
    assert st.checkpoint_config is staged


def test_defaults_and_effective_batch():
    st = StokeStatus(batch_size_per_device=8, grad_accum=4)
    assert st.precision_config == PrecisionConfig()
    assert st.grad_accum == 4 and st.device.value == "cuda"
    assert st.effective_batch_size is None
    st.set_post_init_values(world_size=1)
    assert st.effective_batch_size == 32
    with pytest.raises(StokeValidationError, match="grad_clip"):
        StokeStatus(batch_size_per_device=4, grad_clip=3.0)


# --------------------------------------------------------------------------- #
# facade guards, on a linear model on the CPU
# --------------------------------------------------------------------------- #


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _stoke(**kw):
    torch.manual_seed(0)
    kw.setdefault("batch_size_per_device", 8)
    kw.setdefault("device", "cpu")
    return Stoke(nn.Linear(4, 2), StokeOptimizer(torch.optim.SGD, lr=0.2),
                 _mse, **kw)


def _batch(seed=0):
    x = np.random.default_rng(seed).normal(size=(8, 4)).astype(np.float32)
    return x, x @ np.ones((4, 2), np.float32)


def test_no_cuda_and_no_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Stoke(nn.Linear(4, 2), StokeOptimizer(torch.optim.SGD, lr=0.1), _mse,
              batch_size_per_device=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StokeDataLoader(ArrayDataset(np.zeros((4, 2))), batch_size=2)


def test_backward_guards():
    s = _stoke()
    with pytest.raises(RuntimeError, match="without a preceding loss"):
        s.backward()
    x, y = _batch()
    s.eval()
    out = s.model(x)
    assert not out.requires_grad
    loss = s.loss(out, y)
    with pytest.raises(RuntimeError, match="eval mode"):
        s.backward(loss)
    with pytest.raises(RuntimeError, match="eval mode"):
        s.train_step(x, y)
    s.train()
    # a loss of a detached output leaves backward() nothing to commit
    s.loss(s.model(x).detach(), y)
    with pytest.raises(RuntimeError, match="without a preceding loss"):
        s.backward()


def test_step_before_boundary_is_a_noop():
    s = _stoke(grad_accum=2)
    x, y = _batch()
    s.backward(s.loss(s.model(x), y))
    w = s.model_access.weight.detach().clone()
    s.step()
    assert torch.equal(w, s.model_access.weight)
    assert (s.optimizer_steps, s.grad_accum_counter, s.backward_steps) == (
        0, 1, 1)
    s.backward(s.loss(s.model(x), y))
    s.step()
    assert not torch.equal(w, s.model_access.weight)
    assert (s.optimizer_steps, s.grad_accum_counter, s.backward_steps) == (
        1, 0, 2)


def test_later_entry_points_raise():
    # save and load landed with item 6a, verified resume with item 9
    # (without a checkpoint it starts fresh) and the cost card with 10c:
    # it returns a card and the run's state is as it was
    s = _stoke()
    assert s.resume() is False and s.optimizer_steps == 0
    w = s.model_access.weight.detach().clone()
    x, y = (torch.from_numpy(a) for a in _batch())
    card = s.estimate_step_cost(x, y)
    assert card.program == "fused" and card.steps == 1
    assert card.flops == s.estimate_step_flops(x, y) > 0
    assert card.bytes_accessed > 0
    assert torch.equal(w, s.model_access.weight) and s.optimizer_steps == 0
    assert s.model_access.weight.grad is None
