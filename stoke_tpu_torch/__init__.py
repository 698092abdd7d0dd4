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
  parallel, transport, telemetry, trace, health and profiler configs and
  refuses the others naming their ROADMAP item), a run described as a
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
  post-mortem bundles and a hang watchdog (:class:`HealthConfig`), and
  ``torch.profiler`` traces (:class:`ProfilerConfig`).
"""

from stoke_tpu_torch.configs import (
    CheckpointConfig,
    ClipGradConfig,
    ClipGradNormConfig,
    HealthConfig,
    PrecisionConfig,
    ProfilerConfig,
    StokeOptimizer,
    TelemetryConfig,
    TensorboardConfig,
    TraceConfig,
)
from stoke_tpu_torch.data import (
    ArrayDataset,
    BucketedDistributedSampler,
    RaggedSequenceDataset,
    StokeDataLoader,
)
from stoke_tpu_torch.facade import Stoke
from stoke_tpu_torch.status import StokeValidationError

__all__ = [
    "ArrayDataset",
    "BucketedDistributedSampler",
    "CheckpointConfig",
    "ClipGradConfig",
    "ClipGradNormConfig",
    "HealthConfig",
    "PrecisionConfig",
    "ProfilerConfig",
    "RaggedSequenceDataset",
    "Stoke",
    "StokeDataLoader",
    "StokeOptimizer",
    "StokeValidationError",
    "TelemetryConfig",
    "TensorboardConfig",
    "TraceConfig",
]
