"""Training health monitor: on-device numerics sentinels, host-side
anomaly detectors, and the hang watchdog (the port's counterpart of
``stoke_tpu/telemetry/health.py``; the flight recorder is
:mod:`stoke_tpu_torch.telemetry.recorder`).

- **Sentinels** — per-step diagnostics (loss, global grad/param norms,
  update ratio, non-finite leaf count, scaler-skip flag, error-feedback
  residual norm, first non-finite leaf) packed into one fp32 vector on
  the device. ``StepEngine.apply`` computes the row (the JAX
  ``compute_sentinels``) from :func:`leaf_norms`, :func:`nonfinite_flags`
  and :func:`pack_sentinels` inside the apply, so a window replayed from
  a CUDA graph still yields a row for every step, and the facade reads
  the rows back once a call. The leaves are in the JAX package's flatten
  order (:func:`leaf_path_names`), so ``first_nonfinite_leaf`` names the
  same leaf as the JAX package.
- **Detectors** — host-side checks over the sentinel stream and the
  telemetry registry (loss/grad-norm spike z-score vs a running EMA,
  non-finite gradients, fp16 scaler-skip streaks, recompile storms,
  loader starvation streaks, error-feedback residual runaway), each firing
  one of four actions: ``record`` / ``warn`` / ``dump`` / ``halt``. They
  are the JAX package's, line for line.
- **Watchdog** — :class:`HangWatchdog`, a daemon thread armed across a
  step call and the readback that ends it, which fires when the step does
  not complete within the timeout (a wedged collective or a hung kernel),
  dumping all-thread stacks + a post-mortem bundle and optionally
  hard-exiting with :data:`WATCHDOG_EXIT_CODE`.

Everything is default-OFF; without a ``HealthConfig`` the step engine
computes no sentinel and keeps no snapshot.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from stoke_tpu_torch.status import WATCHDOG_EXIT_CODE
from stoke_tpu_torch.telemetry import collectors

#: sentinel vector layout: field name -> index.  The order is the JAX
#: package's wire format; never reorder, only append.
SENTINEL_FIELDS = (
    "step_loss",          # undivided micro loss at the boundary
    "grad_norm",          # global grad norm, unscaled, post-transport, pre-clip
    "param_norm",         # global norm of the updated parameters
    "update_ratio",       # ||param_new - param_old|| / (||param_new|| + eps)
    "nonfinite_leaves",   # gradient leaves containing any non-finite value
    "scaler_skip",        # 1.0 when the fp16 scaler skipped this step
    "comm_residual_norm", # error-feedback residual norm (0 without EF)
    # flat index (JAX leaf order) of the FIRST gradient leaf carrying a
    # non-finite value, -1 when all finite — the NonFiniteDetector maps it
    # to a leaf path so bundles name the culprit
    "first_nonfinite_leaf",
)
SENTINEL_INDEX = {name: i for i, name in enumerate(SENTINEL_FIELDS)}
N_SENTINELS = len(SENTINEL_FIELDS)

#: the update ratio's denominator guard (the JAX package's)
_EPS = 1e-12


class HealthHaltError(RuntimeError):
    """Raised at the facade boundary when a detector with action ``halt``
    fires.  Carries the anomalies that tripped it and the post-mortem
    bundle path (a halt always dumps first — leave a corpse)."""

    def __init__(self, anomalies: List["Anomaly"], bundle: Optional[str]):
        self.anomalies = list(anomalies)
        self.bundle = bundle
        names = ", ".join(a.detector for a in self.anomalies) or "?"
        msg = f"Stoke -- health halt: {names}"
        if bundle:
            msg += f" (post-mortem bundle: {bundle})"
        super().__init__(msg)


# --------------------------------------------------------------------------- #
# the JAX leaf order
# --------------------------------------------------------------------------- #


def jax_leaf_order(module: nn.Module,
                   params: Sequence[torch.Tensor]) -> List[int]:
    """Indices into ``params`` (the module's trainable parameters, in the
    engine's order) in the JAX package's flatten order of the params tree
    (``convert.jax_param_layout``); registration order for a module the
    converter does not know."""
    from stoke_tpu_torch.parallel.collectives import JaxLeafOrder

    return list(JaxLeafOrder(module, params).order)


def leaf_path_names(module: nn.Module,
                    params: Optional[Sequence[torch.Tensor]] = None
                    ) -> List[str]:
    """``"a/b/c"`` path string per gradient leaf, in the JAX flatten order
    (the port's copy of ``stoke_tpu/telemetry/numerics.py``'s
    ``leaf_path_names`` over the params tree): flax's names (``layer_0/
    attn/qkv/kernel``) where the converter knows the module, the port's
    ``/``-joined names otherwise. ``params`` defaults to the module's
    trainable parameters."""
    from stoke_tpu_torch.convert import jax_param_layout

    if params is None:
        params = [p for p in module.parameters() if p.requires_grad]
    names = {id(p): n for n, p in module.named_parameters()}
    try:
        layout = jax_param_layout(module)
    except ValueError:
        layout = {}
    out = []
    for i in jax_leaf_order(module, params):
        name = names[id(params[i])]
        path = layout[name][0] if name in layout else tuple(name.split("."))
        out.append("/".join(path) if path else "params")
    return out


# --------------------------------------------------------------------------- #
# on-device sentinels
# --------------------------------------------------------------------------- #


def leaf_norms(tensors: Sequence[torch.Tensor], p: float = 2.0
               ) -> torch.Tensor:
    """The ``p``-norm of each tensor in fp32, as one vector (one
    multi-tensor pass on the card: ``torch._foreach_norm``)."""
    tensors = list(tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        norms = torch._foreach_norm(tensors, p, dtype=torch.float32)
    else:
        norms = torch._foreach_norm(tensors, p)
    return torch.stack(list(norms))


def nonfinite_flags(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """1.0 for each tensor holding any non-finite value, else 0.0 (the JAX
    package's ``any(~isfinite(leaf))``), from each tensor's largest
    magnitude: that is finite for a finite tensor (a max cannot overflow,
    as a 2-norm's squares can) and inf or NaN for one holding an inf or a
    NaN. One multi-tensor pass, no copy (an empty tensor, which has no
    largest magnitude, is read as one finite zero)."""
    tensors = [t if t.numel() else t.new_zeros(1) for t in tensors]
    return (~torch.isfinite(leaf_norms(tensors, float("inf")))).float()


def first_nonfinite(flags: torch.Tensor) -> torch.Tensor:
    """Index of the first 1.0 in ``flags`` as an fp32 scalar, -1 when there
    is none."""
    if flags.numel() == 0:
        return torch.full((), -1.0, device=flags.device)
    return torch.where(flags.any(), torch.argmax(flags).float(),
                       torch.full((), -1.0, device=flags.device))


def pack_sentinels(loss, grad_norm, param_norm, update_norm, flags,
                   finite, residual_norm) -> torch.Tensor:
    """The ``[N_SENTINELS]`` fp32 row from its device scalars: ``flags``
    are the per-leaf non-finite flags in the JAX leaf order, ``finite`` the
    fp16 finite flag (None: never skipped), ``loss`` None for NaN and
    ``residual_norm`` None for 0."""
    dev = grad_norm.device
    f32 = torch.float32

    def scalar(v, default):
        if v is None:
            return torch.full((), default, dtype=f32, device=dev)
        return torch.as_tensor(v).to(device=dev, dtype=f32).reshape(())

    skip = (torch.zeros((), dtype=f32, device=dev) if finite is None
            else 1.0 - finite.to(device=dev, dtype=f32).reshape(()))
    return torch.stack([
        scalar(loss, float("nan")), grad_norm.to(f32),
        param_norm.to(f32), (update_norm / (param_norm + _EPS)).to(f32),
        flags.sum().to(f32), skip, scalar(residual_norm, 0.0),
        first_nonfinite(flags).to(device=dev, dtype=f32),
    ])


def unpack_sentinels(vec) -> Dict[str, float]:
    """Host-side view of one sentinel row as ``{field: float}``."""
    arr = np.asarray(vec, np.float64).reshape(-1)
    return {name: float(arr[i]) for i, name in enumerate(SENTINEL_FIELDS)}


# --------------------------------------------------------------------------- #
# detectors
# --------------------------------------------------------------------------- #


@dataclass
class Anomaly:
    """One detector firing.  ``context`` carries structured provenance
    (e.g. the first offending leaf path) so
    bundles name the culprit machine-readably, not only in the
    message."""

    detector: str
    step: int
    action: str
    message: str
    value: Optional[float] = None
    context: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "detector": self.detector,
            "step": self.step,
            "action": self.action,
            "message": self.message,
            "value": self.value,
        }
        if self.context is not None:
            out["context"] = dict(self.context)
        return out


class _RunningStats:
    """EMA mean/variance for the z-score spike detectors (an exponentially
    weighted analogue of Welford's update — deterministic, O(1) state)."""

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.count = 0

    def zscore(self, x: float) -> Optional[float]:
        """Z-score of ``x`` against the CURRENT stats (before updating with
        it); None until the first observation."""
        if self.mean is None:
            return None
        std = self.var ** 0.5
        if std <= 0.0:
            return 0.0 if x == self.mean else float("inf")
        return (x - self.mean) / std

    def update(self, x: float) -> None:
        self.count += 1
        if self.mean is None:
            self.mean = float(x)
            self.var = 0.0
            return
        a = self.alpha
        delta = float(x) - self.mean
        self.mean += a * delta
        # EW variance: blends the squared innovation (West 1979 lineage)
        self.var = (1.0 - a) * (self.var + a * delta * delta)


class Detector:
    """Base: ``check(step, sentinels, ctx)`` returns an :class:`Anomaly`
    or None.  ``sentinels`` is the unpacked dict (or None when the
    on-device vector is off); ``ctx`` is the owning monitor (registry /
    compile-tracker access)."""

    name = "detector"

    def __init__(self, action: str):
        self.action = action

    def check(self, step: int, sentinels: Optional[Dict[str, float]],
              ctx: "HealthMonitor") -> Optional[Anomaly]:
        raise NotImplementedError

    def _fire(self, step: int, message: str,
              value: Optional[float] = None) -> Anomaly:
        return Anomaly(self.name, step, self.action, message, value)


class SpikeDetector(Detector):
    """Shared z-score-vs-EMA spike logic for loss / grad-norm."""

    field_name = ""

    def __init__(self, action: str, zscore: float, warmup: int, alpha: float):
        super().__init__(action)
        self.threshold = float(zscore)
        self.warmup = int(warmup)
        self.stats = _RunningStats(alpha)

    def check(self, step, sentinels, ctx):
        if sentinels is None:
            return None
        x = sentinels.get(self.field_name)
        if x is None or not np.isfinite(x):
            # non-finite values are the NonFiniteDetector's job; feeding
            # them into the EMA would poison the baseline forever
            return None
        z = self.stats.zscore(x)
        fired = None
        if (
            z is not None
            and self.stats.count >= self.warmup
            and z > self.threshold
        ):
            fired = self._fire(
                step,
                f"{self.field_name} {x:.6g} is {z:.1f} sigma above its "
                f"running mean {self.stats.mean:.6g} "
                f"(threshold {self.threshold})",
                value=x,
            )
            # a spike must not drag the baseline up to itself: clamp the
            # update to the detection threshold so repeated spikes keep
            # firing instead of normalizing.  With ZERO running variance
            # the clamp would collapse to the mean and a permanent regime
            # shift would fire forever — feed the raw value there so the
            # baseline adapts.
            std = self.stats.var ** 0.5
            if std > 0:
                x = self.stats.mean + self.threshold * std
        self.stats.update(x)
        return fired


class LossSpikeDetector(SpikeDetector):
    name = "loss_spike"
    field_name = "step_loss"


class GradNormSpikeDetector(SpikeDetector):
    name = "grad_norm_spike"
    field_name = "grad_norm"


class NonFiniteDetector(Detector):
    name = "nonfinite_grads"

    def check(self, step, sentinels, ctx):
        if sentinels is None:
            return None
        n = sentinels.get("nonfinite_leaves", 0.0)
        if n and n > 0:
            # leaf-level provenance: the sentinel row
            # carries the FIRST offending leaf's flat index; the monitor's
            # leaf-path table (facade-installed) names it, so the anomaly
            # and its bundle say WHERE even when only HealthConfig is on
            idx = int(sentinels.get("first_nonfinite_leaf", -1.0))
            context = None
            where = ""
            if idx >= 0:
                context = {"first_leaf_index": idx}
                paths = getattr(ctx, "leaf_paths", None)
                if paths and idx < len(paths):
                    context["first_leaf_path"] = paths[idx]
                    where = f" (first offending leaf: {paths[idx]})"
            anomaly = self._fire(
                step,
                f"{int(n)} gradient leaves contain non-finite values at "
                f"step {step}{where}",
                value=n,
            )
            anomaly.context = context
            return anomaly
        return None


class ScalerSkipStreakDetector(Detector):
    name = "scaler_skip_streak"

    def __init__(self, action: str, streak: int):
        super().__init__(action)
        self.streak = int(streak)
        self._run = 0

    def check(self, step, sentinels, ctx):
        if sentinels is None:
            return None
        if sentinels.get("scaler_skip", 0.0) > 0:
            self._run += 1
        else:
            self._run = 0
            return None
        if self._run >= self.streak:
            fired = self._fire(
                step,
                f"{self._run} consecutive fp16 scaler-skipped steps "
                f"(scale collapse?)",
                value=float(self._run),
            )
            self._run = 0  # re-arm: fire once per streak, not per step
            return fired
        return None


class RecompileStormDetector(Detector):
    """Structural recompiles (engine shape-signature collector) growing by
    >= threshold within a sliding step window: shape-polymorphic inputs
    eating the run in silent multi-second compiles."""

    name = "recompile_storm"

    def __init__(self, action: str, threshold: int, window: int):
        super().__init__(action)
        self.threshold = int(threshold)
        self.window = int(window)
        self._history: List[tuple] = []  # (step, cumulative recompiles)

    def check(self, step, sentinels, ctx):
        tracker = ctx.compile_tracker
        if tracker is None:
            return None
        total = tracker.recompiles
        self._history.append((step, total))
        cutoff = step - self.window
        while self._history and self._history[0][0] < cutoff:
            self._history.pop(0)
        delta = total - self._history[0][1]
        if delta >= self.threshold:
            self._history = [(step, total)]  # re-arm
            return self._fire(
                step,
                f"{delta} structural recompiles within the last "
                f"{self.window} steps (shape-polymorphic inputs?)",
                value=float(delta),
            )
        return None


class LoaderStarvationDetector(Detector):
    """Consecutive steps accruing post-warmup loader starvation time: the
    device is waiting on the input pipeline."""

    name = "loader_starvation"

    def __init__(self, action: str, streak: int):
        super().__init__(action)
        self.streak = int(streak)
        self._last = 0.0
        self._run = 0

    def check(self, step, sentinels, ctx):
        counter = ctx.registry.get("data/starvation_s")
        if counter is None:
            return None
        now = counter.value
        grew = now > self._last
        self._last = now
        if grew:
            self._run += 1
        else:
            self._run = 0
            return None
        if self._run >= self.streak:
            fired = self._fire(
                step,
                f"loader starvation accrued on {self._run} consecutive "
                f"steps ({now:.3f}s total; input-pipeline-bound)",
                value=now,
            )
            self._run = 0
            return fired
        return None


class CommResidualRunawayDetector(Detector):
    """Error-feedback residual norm outrunning its own EMA (or going
    non-finite): the int8 transport's quantization error is no longer being
    re-absorbed — the standing correctness monitor a lossy wire format
    requires."""

    name = "comm_residual_runaway"

    def __init__(self, action: str, factor: float, warmup: int, alpha: float):
        super().__init__(action)
        self.factor = float(factor)
        self.warmup = int(warmup)
        self.stats = _RunningStats(alpha)

    def check(self, step, sentinels, ctx):
        if sentinels is None:
            return None
        x = sentinels.get("comm_residual_norm", 0.0)
        if x == 0.0:
            return None  # no transport / no error feedback
        if not np.isfinite(x):
            return self._fire(
                step, "error-feedback residual went non-finite", value=x
            )
        fired = None
        if (
            self.stats.mean is not None
            and self.stats.count >= self.warmup
            and self.stats.mean > 0
            and x > self.factor * self.stats.mean
        ):
            fired = self._fire(
                step,
                f"error-feedback residual norm {x:.6g} exceeds "
                f"{self.factor}x its running mean {self.stats.mean:.6g} "
                f"(quantization error outrunning re-injection)",
                value=x,
            )
        self.stats.update(x)
        return fired


def build_detectors(cfg) -> List[Detector]:
    """Instantiate the detector registry from a ``HealthConfig``."""
    return [
        LossSpikeDetector(
            cfg.loss_spike_action, cfg.loss_spike_zscore,
            cfg.detector_warmup_steps, cfg.ema_alpha,
        ),
        GradNormSpikeDetector(
            cfg.grad_spike_action, cfg.grad_spike_zscore,
            cfg.detector_warmup_steps, cfg.ema_alpha,
        ),
        NonFiniteDetector(cfg.nonfinite_action),
        ScalerSkipStreakDetector(
            cfg.scaler_skip_action, cfg.scaler_skip_streak
        ),
        RecompileStormDetector(
            cfg.recompile_storm_action, cfg.recompile_storm_threshold,
            cfg.recompile_storm_window,
        ),
        LoaderStarvationDetector(
            cfg.starvation_action, cfg.starvation_streak
        ),
        CommResidualRunawayDetector(
            cfg.comm_residual_action, cfg.comm_residual_factor,
            cfg.detector_warmup_steps, cfg.ema_alpha,
        ),
    ]


# --------------------------------------------------------------------------- #
# hang watchdog
# --------------------------------------------------------------------------- #


class HangWatchdog:
    """Daemon thread firing when an armed dispatch does not complete in
    time (the wedged-collective / hung-kernel case: the training thread is
    stuck inside a device call and can never report the hang itself).

    ``arm()`` before a dispatch, ``disarm()`` once the step (and its
    sentinel fetch) completed.  On trip: ``on_trip()`` runs on the watchdog
    thread (dump stacks + bundle), then — with ``kill=True`` — the process
    hard-exits with :data:`WATCHDOG_EXIT_CODE` so a supervisor can tell
    "hung and self-terminated" from a generic timeout.  Fires once per arm.
    """

    def __init__(
        self,
        timeout_s: float,
        on_trip: Callable[[], None],
        *,
        kill: bool = False,
        exit_code: int = WATCHDOG_EXIT_CODE,
    ):
        self.timeout_s = float(timeout_s)
        self.on_trip = on_trip
        self.kill = bool(kill)
        self.exit_code = int(exit_code)
        self.trips = 0
        self._deadline: Optional[float] = None
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="stoke-health-watchdog", daemon=True
        )
        self._thread.start()

    def arm(self, timeout_s: Optional[float] = None) -> None:
        """Arm (or re-arm, extending the deadline) for one dispatch;
        ``timeout_s`` overrides the default — callers scale it by the
        steps a dispatch covers and by warm-up compile grace."""
        with self._lock:
            self._deadline = time.monotonic() + (
                self.timeout_s if timeout_s is None else float(timeout_s)
            )
        self._wake.set()

    def extend(self, seconds: float) -> None:
        """Push the deadline of an armed watchdog out by ``seconds``
        (nothing when disarmed)."""
        with self._lock:
            if self._deadline is not None:
                self._deadline += float(seconds)

    def disarm(self) -> None:
        with self._lock:
            self._deadline = None

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop:
            with self._lock:
                deadline = self._deadline
            if deadline is None:
                self._wake.wait(timeout=self.timeout_s)
                self._wake.clear()
                continue
            wait = deadline - time.monotonic()
            if wait > 0:
                # short slices so a disarm/stop is honored promptly
                self._wake.wait(timeout=min(wait, 0.05))
                self._wake.clear()
                continue
            with self._lock:
                # re-check under the lock: the step may have completed (or
                # re-armed) while we were deciding to fire
                if self._deadline is None or self._deadline > time.monotonic():
                    continue
                self._deadline = None  # fire once per arm
            self.trips += 1
            try:
                self.on_trip()
            except Exception:
                pass
            if self.kill:
                import os

                os._exit(self.exit_code)


# --------------------------------------------------------------------------- #
# the monitor
# --------------------------------------------------------------------------- #

#: warnings per detector before the "warn" action degrades to "record"
#: (a detector firing every step must not drown the log)
MAX_WARNINGS_PER_DETECTOR = 5

#: Anomaly OBJECTS retained for inspection (counters are unbounded; the
#: object list must not grow without bound over a multi-day run with a
#: permanently-firing detector)
RECENT_ANOMALIES_MAX = 1024


class HealthMonitor:
    """Owns the detector registry, the flight recorder, and the watchdog;
    the facade calls :meth:`observe` once per completed optimizer step.

    Anomaly counters land in the telemetry registry
    (``health/anomalies_total``, ``health/anomaly_<detector>_total``,
    ``health/bundles_total``, ``health/watchdog_trips_total``) and are
    therefore exposed through the Prometheus/JSONL sinks for free.
    """

    def __init__(self, cfg, registry, recorder, *,
                 compile_tracker=None):
        self.cfg = cfg
        self.registry = registry
        self.recorder = recorder
        self.compile_tracker = compile_tracker
        self.detectors = build_detectors(cfg)
        # bounded recent-anomaly window; totals live in the int counters
        # below (and the registry), never in list length
        self.anomalies: "deque[Anomaly]" = deque(maxlen=RECENT_ANOMALIES_MAX)
        self._anomaly_total = 0
        self._by_detector: Dict[str, int] = {}
        self._anomaly_dumps = 0
        self._exception_dumps = 0
        self._warned: Dict[str, int] = {}
        self._steps_completed = False
        # the name of the detector that halted the run, set just before
        # HealthHaltError leaves observe() and never cleared: the ops
        # plane's /healthz reads it as the load-balancer
        # drain signal, which must survive the exception unwinding
        self.halted: Optional[str] = None
        # flat-leaf-index -> path-string table for the param/grad tree
        # (facade-installed; :func:`leaf_path_names`, JAX order) — the
        # NonFiniteDetector's leaf-level provenance lookup
        self.leaf_paths: Optional[List[str]] = None
        self.watchdog: Optional[HangWatchdog] = None
        if cfg.watchdog:
            self.watchdog = HangWatchdog(
                cfg.watchdog_timeout_s,
                self._on_watchdog_trip,
                kill=cfg.watchdog_kill,
            )
            collectors.watch_compiles(self)
        # pre-register so scrapes carry zeros before the first anomaly
        registry.counter(
            "health/anomalies_total", help="health detector firings"
        )
        registry.counter(
            "health/bundles_total", help="post-mortem bundles written"
        )
        registry.counter(
            "health/watchdog_trips_total", help="hang-watchdog firings"
        )
        registry.counter(
            "health/halt_s",
            help="wall seconds spent writing health dumps / halting "
            "(the goodput ledger's halt bucket)",
        )

    # ------------------------------ hooks ------------------------------ #

    def arm_watchdog(self, steps: int = 1) -> None:
        """Arm the hang watchdog for one upcoming dispatch.  The deadline
        scales with the optimizer steps the dispatch covers (a
        ``train_steps(n)`` segment legitimately runs n steps in one
        program) and, until the FIRST step has ever completed, by the
        compile-grace allowance (the first-use kernel builds can dwarf a
        steady-state step; a later window's first CUDA-graph capture
        extends the deadline by the same grace while it runs,
        :meth:`extend_for_compile`).  No-op without a watchdog."""
        if self.watchdog is None:
            return
        timeout = self.cfg.watchdog_timeout_s * max(1, int(steps))
        if not self._steps_completed:
            timeout += max(0.0, self.cfg.watchdog_compile_grace_s)
        self.watchdog.arm(timeout)

    def extend_for_compile(self) -> None:
        """Push an armed watchdog's deadline out by the compile grace: a
        kernel build or a window capture is starting
        (:func:`~stoke_tpu_torch.telemetry.collectors.compiling`)."""
        if self.watchdog is not None:
            self.watchdog.extend(
                max(0.0, self.cfg.watchdog_compile_grace_s))

    def disarm_watchdog(self) -> None:
        if self.watchdog is not None:
            self.watchdog.disarm()

    def _on_watchdog_trip(self) -> None:
        self.registry.counter("health/watchdog_trips_total").inc()
        self.recorder.record("note", {
            "note": "watchdog trip",
            "timeout_s": self.cfg.watchdog_timeout_s,
        })
        self.dump(
            "watchdog",
            extra={
                "timeout_s": self.cfg.watchdog_timeout_s,
                "exit_code": (
                    WATCHDOG_EXIT_CODE if self.cfg.watchdog_kill else None
                ),
            },
        )

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None) -> str:
        """The single bundle-writing funnel (anomaly/halt/watchdog/
        exception/manual): counts into ``health/bundles_total`` and
        delegates to the recorder.  Uncapped — only the anomaly ``dump``
        action applies the ``max_dumps`` budget, in ``observe``.  (Signal
        dumps go straight through the recorder's handler and skip the
        counter: the handler must stay registry-free to be
        deadlock-safe.)"""
        self.registry.counter("health/bundles_total").inc()
        t0 = time.monotonic()
        try:
            return self.recorder.dump(reason, extra)
        finally:
            # wall clock lost to the dump: the goodput ledger's halt
            # bucket reads this counter's per-window delta
            self.registry.counter("health/halt_s").inc(
                time.monotonic() - t0
            )

    def close(self) -> None:
        if self.watchdog is not None:
            collectors.unwatch_compiles(self)
            self.watchdog.stop()
        self.recorder.uninstall_signal_handlers()

    @property
    def anomaly_count(self) -> int:
        """Cumulative detector firings (NOT bounded by the retained-object
        window)."""
        return self._anomaly_total

    def anomaly_counts_by_detector(self) -> Dict[str, int]:
        return dict(self._by_detector)

    def note_exception_dump(self) -> bool:
        """Budget gate for exception-path bundles: True while under the
        ``max_dumps`` cap (a caller retrying a failing call in a loop must
        not fill the disk with identical corpses)."""
        if self._exception_dumps >= max(1, self.cfg.max_dumps):
            return False
        self._exception_dumps += 1
        return True

    # ----------------------------- observe ----------------------------- #

    def observe(self, step: int,
                sentinel_row: Optional[np.ndarray]) -> List[Anomaly]:
        """Run every detector against one completed optimizer step.

        ``sentinel_row`` is the fetched on-device vector (None when
        sentinels are off — registry-driven detectors still run).  Applies
        each firing's action; a ``halt`` firing raises
        :class:`HealthHaltError` after all detectors ran and the bundle was
        written (the facade calls this at its step boundary, so the raise
        IS the facade-boundary halt).
        """
        self._steps_completed = True  # un-gates the watchdog compile grace
        sentinels = (
            unpack_sentinels(sentinel_row)
            if sentinel_row is not None else None
        )
        if sentinels is not None:
            self.recorder.record(
                "sentinels", {"step": step, "values": sentinels}
            )
        fired: List[Anomaly] = []
        for det in self.detectors:
            try:
                anomaly = det.check(step, sentinels, self)
            except Exception as e:  # a broken detector must not kill a run
                warnings.warn(
                    f"Stoke -- health detector {det.name} raised {e!r}; "
                    f"skipping it this step"
                )
                continue
            if anomaly is not None:
                fired.append(anomaly)
        if not fired:
            return fired
        halts: List[Anomaly] = []
        bundle: Optional[str] = None
        for anomaly in fired:
            self.anomalies.append(anomaly)
            self._anomaly_total += 1
            self._by_detector[anomaly.detector] = (
                self._by_detector.get(anomaly.detector, 0) + 1
            )
            self.registry.counter("health/anomalies_total").inc()
            self.registry.counter(
                f"health/anomaly_{anomaly.detector}_total",
                help=f"{anomaly.detector} detector firings",
            ).inc()
            self.recorder.record("anomaly", anomaly.to_dict())
            if anomaly.action == "warn":
                n = self._warned.get(anomaly.detector, 0)
                if n < MAX_WARNINGS_PER_DETECTOR:
                    self._warned[anomaly.detector] = n + 1
                    warnings.warn(f"Stoke -- health: {anomaly.message}")
            elif anomaly.action == "dump":
                if self._anomaly_dumps < self.cfg.max_dumps:
                    self._anomaly_dumps += 1
                    bundle = self.dump(
                        f"anomaly-{anomaly.detector}",
                        extra=anomaly.to_dict(),
                    )
            elif anomaly.action == "halt":
                halts.append(anomaly)
        if halts:
            self.halted = halts[0].detector
            bundle = self.dump(
                f"halt-{halts[0].detector}",
                extra=[a.to_dict() for a in halts],
            )
            raise HealthHaltError(halts, bundle)
        return fired
