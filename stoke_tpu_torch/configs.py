"""Configuration of the port: the option enums, the training configs the
port takes (``PrecisionConfig``, ``ClipGradConfig``, ``ClipGradNormConfig``,
``CheckpointConfig``, ``StokeOptimizer``), ``ServeConfig`` and
``ParamNormalize``.

Field names and defaults are those of ``stoke_tpu.configs``, so one config
describes a run in either package. ``DeviceOptions`` is ``cpu`` or
``cuda`` where the JAX package has ``cpu`` or ``tpu``.

``ServeConfig`` describes a serve run. The port's
:class:`~stoke_tpu_torch.serving.ServingEngine` serves the greedy path
(paged KV cache, continuous batching, ``attention`` "dense" or "flash",
``decode_kernel`` "reference" or "pallas"); the fields of features that
later slices port (sampling, speculative decoding, chunked prefill,
weight quantization, SLO and cost accounting) are kept so configs carry
over, and the engine refuses them with ``NotImplementedError`` until then.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Optional


class DeviceOptions(Enum):
    """Compute device: the CPU, or the CUDA card."""

    cpu = "cpu"
    cuda = "cuda"


class DistributedOptions(Enum):
    """Distributed strategy: data parallelism (not ported yet)."""

    dp = "dp"


class PrecisionOptions(Enum):
    """Precision: ``full`` (fp32), ``bf16`` (fp32 master params, the model
    run in bfloat16) or ``fp16`` (the same in float16, with a dynamic loss
    scaler)."""

    full = "full"
    bf16 = "bf16"
    fp16 = "fp16"


class ParamNormalize(Enum):
    """Divisors for printing parameter counts
    (``Stoke.num_model_parameters``)."""

    BILLION = 1e9
    GIGA = 2**30
    KILO = 2**10
    MEGA = 2**20
    MILLION = 1e6
    THOUSAND = 1e3


class CheckpointFormat(Enum):
    """Checkpoint layouts: ``consolidated`` (one ``.npz`` a state key,
    written by one process) or ``sharded`` (every process writes its
    shards; not ported yet)."""

    consolidated = "consolidated"
    sharded = "sharded"


@dataclass
class PrecisionConfig:
    """Precision policy and loss-scaler tunables.

    Attributes:
        param_dtype: dtype of the master copy of the parameters.
        output_dtype: dtype the model's outputs are cast to under bf16.
        init_scale / growth_factor / backoff_factor / growth_interval /
            min_scale / num_losses: the fp16 loss scaler's
            (``num_losses > 1``, one scaler a loss, needs fp16).
    """

    param_dtype: str = "float32"
    output_dtype: str = "float32"
    init_scale: float = 2.0**16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    min_scale: float = 1.0
    num_losses: int = 1


@dataclass
class ClipGradConfig:
    """Clip gradients element-wise to ``[-clip_value, clip_value]``."""

    clip_value: float = 1.0


@dataclass
class ClipGradNormConfig:
    """Scale all gradients by ``min(1, max_norm / (norm + 1e-6))``, with
    ``norm`` their global ``norm_type``-norm (``inf``: the largest
    magnitude)."""

    max_norm: float = 1.0
    norm_type: float = 2.0


@dataclass
class CheckpointConfig:
    """How ``Stoke.save`` writes and when the step path saves on its own.

    Attributes:
        format: the layout, ``consolidated`` (``sharded`` is not ported
            yet and is refused).
        max_to_keep: the newest tags of a name kept under a path; older
            ones are deleted after each save (None keeps all).
        async_save: copy the state to the host on the calling thread and
            write the files on a background thread
            (``Stoke.wait_for_checkpoint`` waits for it and raises its
            failure).
        save_every_n_steps / auto_path / auto_name: save under
            ``auto_path`` with the name ``auto_name`` after every
            ``save_every_n_steps`` optimizer steps (``Stoke.maybe_resume``
            loads the newest such tag).
        save_rank: the process that writes (one process here: 0).
        offload_staging: the JAX package's staged async save (not ported
            yet and refused).
    """

    format: CheckpointFormat = CheckpointFormat.consolidated
    max_to_keep: Optional[int] = None
    async_save: bool = False
    save_every_n_steps: Optional[int] = None
    auto_path: Optional[str] = None
    auto_name: str = "auto"
    save_rank: int = 0
    offload_staging: bool = False


class StokeOptimizer(dict):
    """An uninstantiated ``torch.optim`` optimizer: ``optimizer`` is its
    class (or any callable taking the parameters first) and
    ``optimizer_kwargs`` its keyword arguments. The facade builds it over
    the model's parameters.

    ``StokeOptimizer(torch.optim.AdamW, lr=3e-4)`` and
    ``StokeOptimizer(optimizer=torch.optim.AdamW,
    optimizer_kwargs={"lr": 3e-4})`` are the same; the keys are those of
    the JAX package's ``StokeOptimizer`` dict."""

    def __init__(self, optimizer: Callable[..., Any],
                 optimizer_kwargs: Optional[Dict[str, Any]] = None,
                 **kwargs):
        super().__init__(optimizer=optimizer,
                         optimizer_kwargs={**(optimizer_kwargs or {}),
                                           **kwargs})


@dataclass
class ServeConfig:
    """Serving engine configuration (continuous batching over a paged KV
    cache).

    Attributes:
        max_seqs: decode slot count; every decode step runs this batch.
        kv_block_size: tokens per KV block.
        kv_blocks: blocks in the pool, scratch block 0 included; ``None``
            sizes it to ``max_seqs`` full-length sequences plus scratch.
        max_seq_len: per-request prompt + output cap.
        max_new_tokens: default per-request generation cap.
        prefill_pad_multiple: prompts are zero-padded to a multiple of this
            before prefill.
        attention: prefill attention, "dense" (causal bias, fp32 softmax)
            or "flash" (the flash forward kernel, ``causal=True``).
        decode_kernel: decode attention, "reference" (gather + einsum +
            softmax in PyTorch) or "pallas" (the paged-decode kernel; the
            name is the JAX package's, kept so one config means one path
            in both packages).
        kv_dtype: KV-cache storage dtype, "float32" or "bfloat16".
        eos_id: token id that finishes a request early (None = run to the
            cap).
        log_every_n_steps: engine iterations between gauge refreshes.
        decode_pages_per_block / decode_block_h / verify_pages_per_block /
            verify_block_h: the TPU kernels' block knobs; the CUDA kernels
            choose their own tiles, so the port refuses them.
        prefill_chunk_tokens, sampling, temperature, top_k, top_p,
            sampling_seed, quant, quant_chunk_elems, quant_stochastic,
            quant_min_size, slo_ttft_target_s, slo_tpot_target_s,
            speculative_k, speculative_ngram_max, speculative_ngram_min,
            cost_cards: features of later slices (see the JAX package's
            ``ServeConfig`` for their meaning).
    """

    max_seqs: int = 8
    kv_block_size: int = 16
    kv_blocks: Optional[int] = None
    max_seq_len: int = 512
    max_new_tokens: int = 64
    prefill_pad_multiple: int = 64
    attention: str = "dense"
    decode_kernel: str = "reference"
    decode_pages_per_block: Optional[int] = None
    decode_block_h: Optional[int] = None
    prefill_chunk_tokens: Optional[int] = None
    sampling: bool = False
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    sampling_seed: int = 0
    kv_dtype: str = "float32"
    quant: str = "none"
    quant_chunk_elems: int = 128
    quant_stochastic: bool = False
    quant_min_size: int = 1024
    eos_id: Optional[int] = None
    log_every_n_steps: int = 8
    slo_ttft_target_s: Optional[float] = None
    slo_tpot_target_s: Optional[float] = None
    speculative_k: Optional[int] = None
    speculative_ngram_max: int = 3
    speculative_ngram_min: int = 1
    verify_pages_per_block: Optional[int] = None
    verify_block_h: Optional[int] = None
    cost_cards: bool = False
