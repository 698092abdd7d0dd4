"""stoke_tpu_torch: the PyTorch/CUDA port of stoke_tpu for NVIDIA Hopper.

The package imports ``torch`` and nothing of JAX or of ``stoke_tpu``. Its
entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; the attention kernels are hand-written CUDA for
``sm_90a`` (``csrc/``), built at first use, each with a plain PyTorch
version beside it.

What it covers so far:

- training on one device through the :class:`Stoke` facade: the
  four-call ``model -> loss -> backward -> step`` loop, ``train_step``,
  and whole accumulation windows (``train_step_window``, ``train_steps``;
  on the card each window a replayed CUDA graph), in fp32, bf16 or fp16
  with its dynamic loss scaler (``Stoke.loss_scale``,
  ``Stoke.skipped_optimizer_steps``), with :class:`StokeDataLoader`;
  flash attention's forward and backward on the CUDA kernels;
- every config class and status rule of the JAX package (the port
  honours the precision, clip, checkpoint, serve, TensorBoard, data
  parallel, transport, telemetry, trace, health, profiler, resilience,
  offload, observatory and remat configs and refuses the others naming
  their ROADMAP item), a run described as a
  YAML document or dict (:func:`stoke_tpu_torch.utils.stoke_from_config`),
  and ragged token sequences batched by the C++ batcher under
  :class:`BucketedDistributedSampler`;
- checkpoints on one device (``Stoke.save`` / ``load`` /
  ``maybe_resume``, async and periodic saves by
  :class:`CheckpointConfig`; :mod:`stoke_tpu_torch.io_ops`), a JAX
  checkpoint resumed in the port
  (:func:`stoke_tpu_torch.convert.jax_checkpoint_to_port`), and
  ``Stoke.serve()`` over the run's GPT;
- the models (:mod:`stoke_tpu_torch.models`): GPT (with the chunked LM
  head, :func:`stoke_tpu_torch.ops.chunked_causal_lm_loss`), BasicNN,
  ResNet-18 to -152 with flax's BatchNorm, ViT and BERT sequence
  classification, each loadable from the
  JAX package's weights (:mod:`stoke_tpu_torch.convert`);
- serving GPT through :class:`stoke_tpu_torch.serving.ServingEngine`
  (paged KV cache, continuous batching, sampling, chunked prefill and
  speculative decoding);
- telemetry, tracing and health (:mod:`stoke_tpu_torch.telemetry`): JSONL
  step events in the JAX schema, a Prometheus file and TensorBoard
  (:class:`TelemetryConfig`), host span traces in Perfetto's format
  (:class:`TraceConfig`), on-device sentinels with anomaly detectors,
  post-mortem bundles and a hang watchdog (:class:`HealthConfig`),
  ``torch.profiler`` traces (:class:`ProfilerConfig`), and the
  observatories: cost cards, MFU and goodput (:class:`AttributionConfig`),
  per-layer numerics (:class:`NumericsConfig`), the device-memory ledger
  (:class:`MemoryConfig`), and the serving engine's SLO tracking and cost
  cards;
- rematerialization (:mod:`stoke_tpu_torch.remat`):
  :class:`ActivationCheckpointingConfig` and the models' ``remat=True``,
  the dropout masks replayed in the recompute;
- resilience (:mod:`stoke_tpu_torch.resilience`): preemption-safe
  emergency saves, digest manifests, verified resume with quarantine,
  elastic resume with the residual remap, the fault injector, and the
  restart supervisor (``python -m stoke_tpu_torch.supervise -- cmd``);
  offload (:mod:`stoke_tpu_torch.offload`): the optimizer state in pinned
  host memory or on disk between steps, and async saves staged through
  pinned buffers.

The names below load at first use, so ``python -m
stoke_tpu_torch.supervise`` runs without importing ``torch``.
"""

import importlib
from typing import Any

#: public name -> the module that defines it
_EXPORTS = {
    "ActivationCheckpointingConfig": "configs",
    "ArrayDataset": "data",
    "AttributionConfig": "configs",
    "BucketedDistributedSampler": "data",
    "CheckpointConfig": "configs",
    "ClipGradConfig": "configs",
    "ClipGradNormConfig": "configs",
    "HealthConfig": "configs",
    "MemoryConfig": "configs",
    "NumericsConfig": "configs",
    "OffloadDiskConfig": "configs",
    "OffloadOptimizerConfig": "configs",
    "PrecisionConfig": "configs",
    "ProfilerConfig": "configs",
    "RaggedSequenceDataset": "data",
    "ResilienceConfig": "configs",
    "Stoke": "facade",
    "StokeDataLoader": "data",
    "StokeOptimizer": "configs",
    "StokeValidationError": "status",
    "TelemetryConfig": "configs",
    "TensorboardConfig": "configs",
    "TraceConfig": "configs",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    module = _EXPORTS.get(name)
    if module is None:
        # a submodule (``stoke_tpu_torch.ops``) reached as an attribute
        try:
            return importlib.import_module(f"{__name__}.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
