"""State and validation layer of the port: ``StokeStatus``.

Counterpart of ``stoke_tpu/status.py:74-210`` and its properties
(``:1626-1790``) for one device: the flags become one validated status
before any device work happens. Enum values are coerced with the JAX
package's aliases and "valid options" messages, configs are deduplicated
by class name, and the combination rules that apply to one device are
checked in the same order, the checkpoint rules (``:857-903``) and the
serve rules (:func:`serve_config_error`) with the JAX package's messages.
``to_dict`` and ``__repr__`` (``:1870-1887``) give the JAX keys and values
over the flags and config classes the port has; a checkpoint's
``meta.json`` carries the dict.

The configs it takes: ``PrecisionConfig``, ``ClipGradConfig``,
``ClipGradNormConfig``, ``CheckpointConfig`` and ``ServeConfig``. Flags and
settings of later slices pass the same legality rules first and are then
refused with ``NotImplementedError`` naming their ROADMAP item:
``distributed`` and the oss/sddp/fsdp tiers (item 5), the sharded
checkpoint format (item 6b) and offload staging (item 9). fp16 (with
per-loss scalers when ``PrecisionConfig.num_losses > 1``) is legal.

:func:`serve_config_error` holds the serving rules (``stoke_tpu/status.py
:1038-1261``) with the JAX package's messages, but for the rule that
refuses the TPU decode kernel on the CPU (the port's decode kernel runs
its plain version there); ``ServingEngine`` and ``Stoke.serve`` check
their config with it.
"""

from __future__ import annotations

import dataclasses
import warnings
from enum import Enum
from typing import Any, Dict, Optional, Sequence, Union

from stoke_tpu_torch.configs import (
    CheckpointConfig,
    CheckpointFormat,
    ClipGradConfig,
    ClipGradNormConfig,
    DeviceOptions,
    DistributedOptions,
    PrecisionConfig,
    PrecisionOptions,
    ServeConfig,
)

_LATER_DISTRIBUTED = "ROADMAP Queue 1 item 5 (the DP / ZeRO ladder)"
_LATER_SHARDED_IO = (
    "ROADMAP Queue 1 item 6b (the sharded checkpoint format and "
    "multi-process gathers)"
)
_LATER_STAGING = "ROADMAP Queue 1 item 9 (offload and resilience)"

#: the config classes the port takes, by class name
CONFIG_CLASSES = (PrecisionConfig, ClipGradConfig, ClipGradNormConfig,
                  CheckpointConfig, ServeConfig)

# the JAX package's serving vocabularies (stoke_tpu/configs.py:1357-1366)
SERVE_ATTENTION_KERNELS = ("dense", "flash")
SERVE_DECODE_KERNELS = ("reference", "pallas")
SERVE_QUANT_MODES = ("none", "bf16", "int8")
SERVE_KV_DTYPES = ("float32", "bfloat16")


class StokeValidationError(ValueError):
    """Raised when constructor flags form an illegal combination."""


# aliases of the JAX package (status.py:82-103): the reference's
# distributed backends all mean data parallelism, its fp16 flavours bf16
_DISTRIBUTED_ALIASES = {
    "ddp": DistributedOptions.dp,
    "horovod": DistributedOptions.dp,
    "deepspeed": DistributedOptions.dp,
    "dp": DistributedOptions.dp,
    "xla": DistributedOptions.dp,
}
_PRECISION_ALIASES = {
    "full": PrecisionOptions.full,
    "fp32": PrecisionOptions.full,
    "bf16": PrecisionOptions.bf16,
    "bfloat16": PrecisionOptions.bf16,
    "fp16": PrecisionOptions.fp16,
    "float16": PrecisionOptions.fp16,
    "amp": PrecisionOptions.bf16,
    "apex_O1": PrecisionOptions.bf16,
    "apex_O2": PrecisionOptions.bf16,
    "deepspeed": PrecisionOptions.bf16,
}


def _coerce(value, enum_cls, aliases, what):
    if value is None:
        return None
    if isinstance(value, enum_cls):
        return value
    if isinstance(value, str):
        if value in aliases:
            return aliases[value]
        try:
            return enum_cls(value)
        except ValueError:
            pass
    raise StokeValidationError(
        f"Unknown {what} option {value!r}; valid: "
        f"{sorted({*aliases, *[e.value for e in enum_cls]})}"
    )


class StokeStatus:
    """Single source of truth for the run configuration.

    Args:
        batch_size_per_device: micro-batch size (>= 1).
        grad_accum: micro-batches per optimizer step (None = 1; >= 1).
        grad_clip: ``ClipGradConfig``, ``ClipGradNormConfig`` or None.
        device: "cuda" (default) or "cpu".
        distributed: None; "dp" and its aliases are not ported yet.
        precision: None/"full"/"fp32", "bf16" or "fp16" (and the JAX
            package's aliases).
        oss / sddp / fsdp: the sharding tiers, not ported yet.
        configs: config objects, deduplicated by class name (the last one
            of a class wins, with a warning).
    """

    def __init__(
        self,
        batch_size_per_device: Optional[int],
        grad_accum: Optional[int] = None,
        grad_clip: Optional[Union[ClipGradConfig, ClipGradNormConfig]] = None,
        device: Union[str, DeviceOptions] = DeviceOptions.cuda,
        distributed: Optional[Union[str, DistributedOptions]] = None,
        precision: Optional[Union[str, PrecisionOptions]] = None,
        oss: bool = False,
        sddp: bool = False,
        fsdp: bool = False,
        configs: Optional[Sequence[Any]] = None,
    ):
        self._configs = self._set_configs(configs)
        self._status: Dict[str, Any] = {
            "batch_size_per_device": batch_size_per_device,
            "grad_accum": 1 if grad_accum is None else int(grad_accum),
            "grad_clip": grad_clip,
            "device": _coerce(device, DeviceOptions, {}, "device"),
            "distributed": _coerce(
                distributed, DistributedOptions, _DISTRIBUTED_ALIASES,
                "distributed",
            ),
            "precision": _coerce(
                precision, PrecisionOptions, _PRECISION_ALIASES, "precision"
            ) or PrecisionOptions.full,
            "oss": bool(oss),
            "sddp": bool(sddp),
            "fsdp": bool(fsdp),
            "world_size": None,
            "n_devices": None,
            "n_processes": None,
            "effective_batch_size": None,
        }
        self._check_all_raised_combinations()
        self._refuse_later_slices()

    @staticmethod
    def _set_configs(configs: Optional[Sequence[Any]]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for cfg in configs or ():
            name = type(cfg).__name__
            if not isinstance(cfg, CONFIG_CLASSES):
                raise StokeValidationError(
                    f"Unrecognized config object of type {name}; expected "
                    f"one of {[c.__name__ for c in CONFIG_CLASSES]}"
                )
            if name in out:
                warnings.warn(
                    f"Stoke -- Duplicate config {name} supplied; keeping the "
                    f"last one"
                )
            out[name] = cfg
        return out

    def _rules(self):
        """(predicate, message) pairs; a truthy predicate is an illegal
        combination (the one-device rows of the JAX package's table), and
        a predicate that returns a string names the rule itself."""
        pc = self._configs.get("PrecisionConfig")
        return [
            (lambda s: s["batch_size_per_device"] is None
             or s["batch_size_per_device"] < 1,
             "batch_size_per_device must be >= 1"),
            (lambda s: s["grad_accum"] < 1, "grad_accum must be >= 1"),
            (lambda s: s["grad_clip"] is not None and not isinstance(
                s["grad_clip"], (ClipGradConfig, ClipGradNormConfig)),
             "grad_clip must be ClipGradConfig, ClipGradNormConfig, or None"),
            (lambda s: isinstance(s["grad_clip"], ClipGradConfig)
             and s["grad_clip"].clip_value <= 0,
             "ClipGradConfig.clip_value must be > 0 (an elementwise bound "
             "of 0 zeroes every gradient)"),
            (lambda s: isinstance(s["grad_clip"], ClipGradNormConfig)
             and (s["grad_clip"].max_norm <= 0
                  or s["grad_clip"].norm_type < 1),
             "ClipGradNormConfig needs max_norm > 0 and norm_type >= 1 "
             "(inf is legal)"),
            (lambda s: pc is not None and pc.num_losses != 1 and (
                pc.num_losses < 1
                or s["precision"] is not PrecisionOptions.fp16),
             "PrecisionConfig.num_losses > 1 (per-loss scalers) requires "
             "precision='fp16' and num_losses >= 1"),
            (lambda s: (s["oss"] or s["sddp"] or s["fsdp"])
             and s["distributed"] is None,
             "oss/sddp/fsdp shard state across devices and need "
             "distributed='dp'"),
            (lambda s: s["sddp"] and not s["oss"],
             "sddp (gradient sharding) requires oss (optimizer-state "
             "sharding)"),
            (lambda s: s["fsdp"] and (s["oss"] or s["sddp"]),
             "fsdp (fully-sharded) already shards optimizer state and "
             "gradients; combining with oss/sddp is illegal"),
            (self._checkpoint_invalid, "CheckpointConfig is invalid"),
            (lambda s: "ServeConfig" in self._configs and serve_config_error(
                self._configs["ServeConfig"]), "ServeConfig is invalid"),
        ]

    def _checkpoint_invalid(self, s):
        """The JAX checkpoint rules (``stoke_tpu/status.py:857-903``): the
        periodic save must be able to fire, ``save_rank`` is a rank, and
        offload staging is for async consolidated saves only."""
        cfg = self._configs.get("CheckpointConfig")
        if cfg is None:
            return False
        if cfg.save_every_n_steps is not None:
            if cfg.save_every_n_steps < 1:
                return (
                    f"CheckpointConfig.save_every_n_steps must be "
                    f">= 1 or None, got {cfg.save_every_n_steps}"
                )
            if not cfg.auto_path:
                return (
                    "CheckpointConfig.save_every_n_steps is set but "
                    "auto_path is not — the periodic auto-save would "
                    "silently never write; set auto_path or drop the "
                    "cadence"
                )
        if cfg.save_rank < 0:
            return (
                f"CheckpointConfig.save_rank must be >= 0 (taken "
                f"modulo the process count), got {cfg.save_rank}"
            )
        if not cfg.offload_staging:
            return False
        if not cfg.async_save:
            return (
                "CheckpointConfig.offload_staging requires "
                "async_save=True — staging hands device references to "
                "the background writer; a synchronous save has none. "
                "Enable async_save or drop offload_staging"
            )
        if cfg.format is CheckpointFormat.sharded:
            return (
                "CheckpointConfig.offload_staging applies to the "
                "consolidated format only — the sharded (orbax) async "
                "path stages its own device→host copy. Use "
                "format='consolidated' or drop offload_staging"
            )
        return False

    def _check_all_raised_combinations(self) -> None:
        for predicate, message in self._rules():
            result = predicate(self._status)
            if result:
                msg = result if isinstance(result, str) else message
                raise StokeValidationError(
                    f"Stoke -- illegal combination: {msg}"
                )

    def _refuse_later_slices(self) -> None:
        s = self._status
        later = [
            (f"distributed={getattr(s['distributed'], 'value', None)!r}",
             s["distributed"] is not None, _LATER_DISTRIBUTED),
            ("oss/sddp/fsdp", s["oss"] or s["sddp"] or s["fsdp"],
             _LATER_DISTRIBUTED),
        ]
        ckpt = self._configs.get("CheckpointConfig")
        if ckpt is not None:
            later += [
                ("CheckpointConfig(format='sharded')",
                 ckpt.format is CheckpointFormat.sharded, _LATER_SHARDED_IO),
                ("CheckpointConfig(offload_staging=True)",
                 ckpt.offload_staging, _LATER_STAGING),
            ]
        for what, on, item in later:
            if on:
                raise NotImplementedError(
                    f"Stoke -- {what} is not ported yet: {item}"
                )

    def set_post_init_values(self, world_size: int,
                             n_processes: int = 1) -> None:
        """Record the device and process counts once the engine exists;
        the effective batch is per-device batch x devices x grad_accum."""
        self._status["world_size"] = world_size
        self._status["n_devices"] = world_size
        self._status["n_processes"] = n_processes
        self._status["effective_batch_size"] = (
            self._status["batch_size_per_device"] * world_size
            * self._status["grad_accum"]
        )

    @property
    def status(self) -> Dict[str, Any]:
        return dict(self._status)

    @property
    def batch_size(self) -> int:
        return self._status["batch_size_per_device"]

    @property
    def effective_batch_size(self) -> Optional[int]:
        return self._status["effective_batch_size"]

    @property
    def grad_accum(self) -> int:
        return self._status["grad_accum"]

    @property
    def grad_clip(self):
        return self._status["grad_clip"]

    @property
    def device(self) -> DeviceOptions:
        return self._status["device"]

    @property
    def distributed(self) -> Optional[DistributedOptions]:
        return self._status["distributed"]

    @property
    def is_distributed(self) -> bool:
        return self._status["distributed"] is not None

    @property
    def precision(self) -> PrecisionOptions:
        return self._status["precision"]

    @property
    def is_scaled_precision(self) -> bool:
        return self._status["precision"] is PrecisionOptions.fp16

    @property
    def oss(self) -> bool:
        return self._status["oss"]

    @property
    def sddp(self) -> bool:
        return self._status["sddp"]

    @property
    def fsdp(self) -> bool:
        return self._status["fsdp"]

    @property
    def world_size(self) -> Optional[int]:
        return self._status["world_size"]

    def _get_or_default(self, cls):
        if cls.__name__ not in self._configs:
            self._configs[cls.__name__] = cls()
        return self._configs[cls.__name__]

    @property
    def precision_config(self) -> PrecisionConfig:
        return self._get_or_default(PrecisionConfig)

    @property
    def checkpoint_config(self) -> CheckpointConfig:
        return self._get_or_default(CheckpointConfig)

    @property
    def serve_config(self) -> Optional[ServeConfig]:
        """None unless supplied (serving is opt-in; only ``Stoke.serve``
        reads it)."""
        return self._configs.get("ServeConfig")

    def to_dict(self) -> Dict[str, Any]:
        """The status as JSON-friendly values, with the JAX package's keys
        and values (a checkpoint's ``meta.json`` carries it): enums by
        value, a clip config as ``{"type": name, **fields}``, and every
        config supplied or read so far under ``configs``."""
        out = {}
        for k, v in self._status.items():
            if isinstance(v, Enum):
                v = v.value
            elif isinstance(v, (ClipGradConfig, ClipGradNormConfig)):
                v = {"type": type(v).__name__, **asdict_config(v)}
            out[k] = v
        out["configs"] = {k: asdict_config(v)
                          for k, v in self._configs.items()}
        return out

    def __repr__(self) -> str:
        lines = ["Stoke -- Status:"]
        for k, v in self.to_dict().items():
            lines.append(f"  {k}: {v}")
        return "\n".join(lines)


def asdict_config(cfg: Any) -> Dict[str, Any]:
    """A config dataclass as a plain dict with enums by value."""
    if cfg is None:
        return {}
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = v.value if isinstance(v, Enum) else v
    return out


def serve_config_error(cfg: ServeConfig) -> Optional[str]:
    """The first serve rule that ``cfg`` breaks, as the JAX package's
    message, or None: sizes, kernel and dtype names, the block knobs,
    chunked prefill, the sampling knobs, quantization, the pool's
    capacity, SLO targets and speculative decoding, in the JAX package's
    order. Knobs that a disabled feature would silently ignore are
    rejected, never ignored."""
    for field in ("max_seqs", "kv_block_size", "max_seq_len",
                  "max_new_tokens", "prefill_pad_multiple",
                  "log_every_n_steps"):
        if getattr(cfg, field) < 1:
            return (
                f"ServeConfig.{field} must be >= 1, got "
                f"{getattr(cfg, field)}"
            )
    if cfg.attention not in SERVE_ATTENTION_KERNELS:
        return (
            f"ServeConfig.attention {cfg.attention!r} unknown; "
            f"valid: {list(SERVE_ATTENTION_KERNELS)}"
        )
    if cfg.decode_kernel not in SERVE_DECODE_KERNELS:
        return (
            f"ServeConfig.decode_kernel {cfg.decode_kernel!r} "
            f"unknown; valid: {list(SERVE_DECODE_KERNELS)}"
        )
    for field in ("decode_pages_per_block", "decode_block_h"):
        v = getattr(cfg, field)
        if v is not None and v < 1:
            return f"ServeConfig.{field} must be >= 1 when set, got {v}"
        if v is not None and cfg.decode_kernel != "pallas":
            return (
                f"ServeConfig.{field}={v} set but decode_kernel="
                f"{cfg.decode_kernel!r} — only the pallas "
                f"streaming kernel reads the block knobs; set "
                f"decode_kernel='pallas' or drop the knob"
            )
    if cfg.prefill_chunk_tokens is not None:
        c = cfg.prefill_chunk_tokens
        if c < 1:
            return (
                f"ServeConfig.prefill_chunk_tokens must be >= 1, got {c}"
            )
        if c % cfg.prefill_pad_multiple:
            return (
                f"ServeConfig.prefill_chunk_tokens={c} must be a multiple "
                f"of prefill_pad_multiple={cfg.prefill_pad_multiple} — "
                f"chunk shapes ride the same bucket discipline that bounds "
                f"compiled-program count"
            )
        if c > cfg.max_seq_len:
            return (
                f"ServeConfig.prefill_chunk_tokens={c} exceeds "
                f"max_seq_len={cfg.max_seq_len} — no prompt could ever be "
                f"chunked"
            )
    if cfg.temperature < 0.0:
        return f"ServeConfig.temperature must be >= 0, got {cfg.temperature}"
    if cfg.top_k is not None and cfg.top_k < 1:
        return f"ServeConfig.top_k must be >= 1 when set, got {cfg.top_k}"
    if cfg.top_p is not None and not (0.0 < cfg.top_p <= 1.0):
        return (
            f"ServeConfig.top_p must be in (0, 1] when set, got {cfg.top_p}"
        )
    if not cfg.sampling and (
        cfg.temperature != 0.0 or cfg.top_k is not None
        or cfg.top_p is not None
    ):
        return (
            "ServeConfig sampling knobs set (temperature/top_k/top_p) but "
            "sampling=False — the greedy programs would silently ignore "
            "them; set sampling=True or drop the knobs"
        )
    if cfg.quant not in SERVE_QUANT_MODES:
        return (
            f"ServeConfig.quant {cfg.quant!r} unknown; valid: "
            f"{list(SERVE_QUANT_MODES)}"
        )
    if cfg.kv_dtype not in SERVE_KV_DTYPES:
        return (
            f"ServeConfig.kv_dtype {cfg.kv_dtype!r} unknown; "
            f"valid: {list(SERVE_KV_DTYPES)}"
        )
    if cfg.quant_chunk_elems < 1:
        return (
            f"ServeConfig.quant_chunk_elems must be >= 1, got "
            f"{cfg.quant_chunk_elems}"
        )
    if cfg.quant_min_size < 0:
        return (
            f"ServeConfig.quant_min_size must be >= 0 (leaves "
            f"below it stay unquantized), got {cfg.quant_min_size}"
        )
    if cfg.eos_id is not None and cfg.eos_id < 0:
        return (
            f"ServeConfig.eos_id must be a token id >= 0 when "
            f"set (None = run to the token cap), got {cfg.eos_id}"
        )
    if cfg.prefill_pad_multiple > cfg.max_seq_len:
        return (
            f"ServeConfig.prefill_pad_multiple "
            f"{cfg.prefill_pad_multiple} exceeds max_seq_len "
            f"{cfg.max_seq_len} — every padded prompt would be "
            f"rejected"
        )
    if cfg.kv_blocks is not None:
        need = -(-cfg.max_seq_len // cfg.kv_block_size) + 1
        if cfg.kv_blocks < need:
            return (
                f"ServeConfig.kv_blocks={cfg.kv_blocks} cannot "
                f"hold one max_seq_len={cfg.max_seq_len} sequence "
                f"(needs {need} blocks of {cfg.kv_block_size} "
                f"tokens incl. the reserved scratch block 0) — no "
                f"request could ever be admitted"
            )
    for field in ("slo_ttft_target_s", "slo_tpot_target_s"):
        v = getattr(cfg, field)
        if v is not None and not v > 0.0:
            return (
                f"ServeConfig.{field} must be > 0 seconds when "
                f"set, got {v} (None = requests carry their own "
                f"RequestSLO targets)"
            )
    k = cfg.speculative_k
    if k is not None:
        if k < 1:
            return (
                f"ServeConfig.speculative_k must be >= 1 when set (None = "
                f"speculative decoding off), got {k}"
            )
        if not cfg.sampling:
            return (
                f"ServeConfig.speculative_k={k} needs sampling=True — the "
                f"verify program rides the key-threaded sampling programs "
                f"(temperature=0.0 keeps exact greedy streams); set "
                f"sampling=True or drop speculative_k"
            )
        if (cfg.prefill_chunk_tokens is not None
                and k + 1 > cfg.prefill_chunk_tokens):
            return (
                f"ServeConfig.speculative_k={k} puts the verify query width "
                f"(k+1={k + 1}) over the chunk budget prefill_chunk_tokens="
                f"{cfg.prefill_chunk_tokens} — the multi-token programs "
                f"share that per-iteration bound; shrink speculative_k or "
                f"raise prefill_chunk_tokens"
            )
        if cfg.speculative_ngram_min < 1:
            return (
                f"ServeConfig.speculative_ngram_min must be >= 1, got "
                f"{cfg.speculative_ngram_min}"
            )
        if cfg.speculative_ngram_max < cfg.speculative_ngram_min:
            return (
                f"ServeConfig.speculative_ngram_max="
                f"{cfg.speculative_ngram_max} < speculative_ngram_min="
                f"{cfg.speculative_ngram_min} — the drafter's n-gram range "
                f"is empty"
            )
    elif cfg.speculative_ngram_max != 3 or cfg.speculative_ngram_min != 1:
        return (
            "ServeConfig speculative drafter knobs set "
            "(speculative_ngram_max/speculative_ngram_min) but "
            "speculative_k=None — the non-speculative engine would silently "
            "ignore them; set speculative_k or drop the knobs"
        )
    for field in ("verify_pages_per_block", "verify_block_h"):
        v = getattr(cfg, field)
        if v is None:
            continue
        if v < 1:
            return f"ServeConfig.{field} must be >= 1 when set, got {v}"
        if k is None:
            return (
                f"ServeConfig.{field}={v} set but speculative_k=None — only "
                f"the speculative verify kernel reads the verify block "
                f"knobs; set speculative_k or drop the knob"
            )
        if cfg.decode_kernel != "pallas":
            return (
                f"ServeConfig.{field}={v} set but decode_kernel="
                f"{cfg.decode_kernel!r} — the verify block knobs feed the "
                f"pallas verify kernel; set decode_kernel='pallas' or drop "
                f"the knob"
            )
    return None
