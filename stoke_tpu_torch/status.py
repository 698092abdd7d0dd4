"""State and validation layer of the port: ``StokeStatus``.

Counterpart of ``stoke_tpu/status.py:74-210`` and its properties
(``:1626-1720``) for one device: the flags become one validated status
before any device work happens. Enum values are coerced with the JAX
package's aliases and "valid options" messages, configs are deduplicated
by class name, and the combination rules that apply to one device are
checked in the same order.

Flags and configs of later slices pass the same legality rules first and
are then refused with ``NotImplementedError`` naming their ROADMAP item:
``distributed`` and the oss/sddp/fsdp tiers, and every config class other
than ``PrecisionConfig``, ``ClipGradConfig`` and ``ClipGradNormConfig``.
fp16 (with per-loss scalers when ``PrecisionConfig.num_losses > 1``) is
legal.

:func:`serve_config_error` holds the serving rules of chunked prefill, the
sampling knobs and speculative decoding (``stoke_tpu/status.py:1101-1149``,
``:1206-1261``) with the JAX package's messages; ``ServingEngine`` checks
its config with it.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Sequence, Union

from stoke_tpu_torch.configs import (
    ClipGradConfig,
    ClipGradNormConfig,
    DeviceOptions,
    DistributedOptions,
    PrecisionConfig,
    PrecisionOptions,
    ServeConfig,
)

_LATER_DISTRIBUTED = "ROADMAP Queue 1 item 5 (the DP / ZeRO ladder)"
_LATER_CONFIGS = "ROADMAP Queue 1 item 2f (the remaining status rules)"

#: the config classes this slice takes, by class name
CONFIG_CLASSES = (PrecisionConfig, ClipGradConfig, ClipGradNormConfig)
#: config classes of the port that the facade does not take yet
_LATER_CONFIG_CLASSES = (ServeConfig,)


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
            "effective_batch_size": None,
        }
        self._check_all_raised_combinations()
        self._refuse_later_slices()

    @staticmethod
    def _set_configs(configs: Optional[Sequence[Any]]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for cfg in configs or ():
            name = type(cfg).__name__
            if isinstance(cfg, _LATER_CONFIG_CLASSES):
                raise NotImplementedError(
                    f"Stoke -- {name} is not ported yet: {_LATER_CONFIGS}"
                )
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
        combination (the one-device rows of the JAX package's table)."""
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
        ]

    def _check_all_raised_combinations(self) -> None:
        for predicate, message in self._rules():
            if predicate(self._status):
                raise StokeValidationError(
                    f"Stoke -- illegal combination: {message}"
                )

    def _refuse_later_slices(self) -> None:
        s = self._status
        later = [
            (f"distributed={getattr(s['distributed'], 'value', None)!r}",
             s["distributed"] is not None, _LATER_DISTRIBUTED),
            ("oss/sddp/fsdp", s["oss"] or s["sddp"] or s["fsdp"],
             _LATER_DISTRIBUTED),
        ]
        for what, on, item in later:
            if on:
                raise NotImplementedError(
                    f"Stoke -- {what} is not ported yet: {item}"
                )

    def set_post_init_values(self, world_size: int) -> None:
        """Record the device count once the engine exists; the effective
        batch is per-device batch x devices x grad_accum."""
        self._status["world_size"] = world_size
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

    @property
    def precision_config(self) -> PrecisionConfig:
        if "PrecisionConfig" not in self._configs:
            self._configs["PrecisionConfig"] = PrecisionConfig()
        return self._configs["PrecisionConfig"]


def serve_config_error(cfg: ServeConfig) -> Optional[str]:
    """The first rule of chunked prefill, the sampling knobs or speculative
    decoding that ``cfg`` breaks, as the JAX package's message, or None.
    Knobs that a disabled feature would silently ignore are rejected, never
    ignored."""
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
