"""Step-time attribution and goodput accounting (the port's counterpart of
``stoke_tpu/telemetry/attribution.py``).

- :class:`CostCard` / :class:`CostCardCache`: one cost count a (program,
  input signature): FLOPs, bytes accessed, and the roofline-optimal time
  against the configured peaks. Each dispatch then adds its card's FLOPs
  and bytes to the ``attr/*`` counters, so achieved TFLOP/s holds across
  the four step paths and any mix of them.
- :class:`AttributionMonitor`: per-window gauges from those counters'
  deltas: achieved TFLOP/s, **MFU** against ``peak_tflops``, HBM
  bandwidth utilization, a compute / memory / comm / host bound, the
  goodput ledger (productive vs compile vs recompile vs loader vs
  checkpoint vs halt seconds) and the anomaly-triggered profiler capture
  (:class:`AutoCaptureDetector` when a ``HealthConfig`` is there).

The counting funnel. XLA's ``cost_analysis`` reads a lowered program;
eager PyTorch has no program to read, so a card counts the program's
first run of a signature (:func:`counting`): FLOPs by
``torch.utils.flop_counter.FlopCounterMode``, the counter
``Stoke.estimate_step_flops`` uses, with the flash and paged kernels
counted by their registered formulas (dense attention's products); bytes
by summing every dispatched op's input and output tensor bytes, the
kernels at their own formula (the flash ops' Q, K, V, O and LSE; the
paged ops' queries, outputs, tables and the pool pages they read). That
count is unfused: an elementwise chain reads and writes each
intermediate, where XLA's count is of the fused program, so the port's
bytes are higher than the JAX package's for the same step (ROADMAP Queue
3, documented divergence). The counted run is the real dispatch, on the
real inputs: a card costs no extra step and changes no number.

``peak_tflops`` is the caller's: the port states no default. The H100
SXM's data sheet gives 989 TFLOP/s dense bf16 and 3.35 TB/s of HBM3
(NVIDIA H100 80GB HBM3 at a 700 W power limit); a card set to a lower
limit runs slower.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from stoke_tpu_torch.telemetry.health import Anomaly, Detector, _RunningStats

#: goodput bucket names, in emission order
GOODPUT_BUCKETS: Tuple[str, ...] = (
    "productive", "compile", "recompile", "loader", "checkpoint", "halt",
)

#: bound classifications a window can get
BOUND_CLASSES: Tuple[str, ...] = ("compute", "memory", "comm", "host")

#: ops that move no data (views, allocations, metadata)
_NO_BYTES = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_local_scalar_dense", "set_",
    "resize_", "zeros_like", "ones_like", "full_like", "zeros", "ones",
    "full", "scalar_tensor", "arange",
})


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _BytesCounter(TorchDispatchMode):
    """Sums the bytes each dispatched op reads and writes (its tensor
    inputs and outputs), the kernels' custom ops at their own formula
    (``ops.flash_attention.BYTES_FORMULAS``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from stoke_tpu_torch.ops.flash_attention import BYTES_FORMULAS

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        formula = BYTES_FORMULAS.get(packet)
        if formula is not None:
            self.bytes += formula(*args, **kwargs)
        elif not (func.is_view or packet.__name__ in _NO_BYTES):
            self.bytes += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                           + _tensor_bytes(out))
        return out


class Cost:
    """FLOPs and bytes accessed counted by :func:`counting`, as the cost
    dict of the JAX package (``flops``, ``bytes accessed``)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes accessed": self.bytes}


@contextlib.contextmanager
def counting(cost: Optional[Cost] = None) -> Iterator[Cost]:
    """Count the FLOPs and bytes of everything run inside the block into
    ``cost`` (a new :class:`Cost` by default), added on exit."""
    from torch.utils.flop_counter import FlopCounterMode

    cost = Cost() if cost is None else cost
    with FlopCounterMode(display=False) as flops, _BytesCounter() as nbytes:
        yield cost
    cost.flops += float(flops.get_total_flops())
    cost.bytes += float(nbytes.bytes)


@dataclass
class CostCard:
    """Counted cost of ONE dispatch of a program at one signature.

    ``steps`` is how many optimizer steps one dispatch advances (1 for an
    apply, a fused step or a window, 0 for a micro-step)."""

    program: str
    flops: float
    bytes_accessed: Optional[float]
    steps: int
    optimal_time_s: Optional[float] = None
    #: a compiled program's peak in the JAX package; the port keeps its
    #: programs' peaks in the memory observatory, so None here
    peak_hbm_bytes: Optional[float] = None

    @property
    def intensity(self) -> Optional[float]:
        """FLOPs per byte accessed (the roofline's x-axis)."""
        if not self.bytes_accessed or self.flops <= 0:
            return None
        return self.flops / self.bytes_accessed

    def to_dict(self) -> Dict[str, Any]:
        return {
            "program": self.program,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "steps_per_dispatch": self.steps,
            "optimal_time_s": self.optimal_time_s,
            "intensity": self.intensity,
            "peak_hbm_bytes": self.peak_hbm_bytes,
        }

    @classmethod
    def from_cost(cls, cost: Dict[str, Any], program: str, steps: int,
                  peak_tflops: float = 0.0,
                  peak_hbm_gbps: float = 0.0) -> "CostCard":
        """The one cost-dict to card conversion (a missing ``flops`` is 0),
        shared by the live cache and ``Stoke.estimate_step_cost``."""
        flops = float(cost.get("flops") or 0.0)
        bytes_acc = cost.get("bytes accessed")
        bytes_acc = float(bytes_acc) if bytes_acc else None
        return cls(program, flops, bytes_acc, steps,
                   optimal_time_s=roofline_time_s(
                       flops, bytes_acc, peak_tflops, peak_hbm_gbps))


def roofline_time_s(flops: float, bytes_accessed: Optional[float],
                    peak_tflops: float,
                    peak_hbm_gbps: float = 0.0) -> Optional[float]:
    """Roofline-optimal time: the larger of the compute-limited and (with a
    bandwidth peak) the memory-limited bound."""
    if peak_tflops <= 0:
        return None
    t = flops / (peak_tflops * 1e12)
    if bytes_accessed and peak_hbm_gbps > 0:
        t = max(t, bytes_accessed / (peak_hbm_gbps * 1e9))
    return t


def roofline_summary(flops: Optional[float], step_seconds: float,
                     peak_tflops: float) -> Dict[str, Optional[float]]:
    """Achieved TFLOP/s and its share of the peak from FLOPs and a
    measured time."""
    if not flops or step_seconds <= 0:
        return {"achieved_tflops": None, "mfu": None}
    achieved = flops / step_seconds / 1e12
    return {"achieved_tflops": achieved,
            "mfu": achieved / peak_tflops if peak_tflops > 0 else None}


def classify_bound(*, wall_s: float, compute_optimal_s: Optional[float],
                   memory_optimal_s: Optional[float],
                   comm_s: Optional[float], host_s: float,
                   host_fraction: float = 0.5,
                   dominant_fraction: float = 0.4) -> Optional[str]:
    """Compute / memory / comm / host bound of one window (the JAX
    package's rule): host when host time covers ``host_fraction`` of the
    wall clock, else the resource with the largest optimal time if it
    explains ``dominant_fraction`` of it, else host."""
    if wall_s <= 0:
        return None
    if host_s / wall_s >= host_fraction:
        return "host"
    candidates = {
        "compute": compute_optimal_s or 0.0,
        "memory": memory_optimal_s or 0.0,
        "comm": comm_s or 0.0,
    }
    bound = max(candidates, key=lambda k: candidates[k])
    if (candidates[bound] <= 0
            or candidates[bound] / wall_s < dominant_fraction):
        return "host"
    return bound


class CostCardCache:
    """One counted card a (program, signature); every dispatch adds its
    card's FLOPs, bytes and optimal seconds to the ``<prefix>/*``
    counters (``attr`` for training, ``serve/cost`` for serving)."""

    #: cards kept; beyond it an unseen signature reuses its program's
    #: last card, uncounted
    _MAX_CARDS = 1024

    def __init__(self, registry, peak_tflops: float = 0.0,
                 peak_hbm_gbps: float = 0.0, counter_prefix: str = "attr"):
        self.registry = registry
        self.peak_tflops = float(peak_tflops)
        self.peak_hbm_gbps = float(peak_hbm_gbps)
        self.counter_prefix = counter_prefix
        self.cards: Dict[Any, CostCard] = {}
        self.cost_analysis_runs = 0  # one per distinct key
        self._program_fallback: Dict[str, CostCard] = {}
        self._lock = threading.Lock()
        registry.counter(f"{counter_prefix}/flops_total",
                         help="analytic FLOPs dispatched")
        registry.counter(f"{counter_prefix}/bytes_total",
                         help="analytic bytes accessed by dispatches")
        registry.counter(f"{counter_prefix}/optimal_s_total",
                         help="roofline-optimal seconds of dispatched "
                              "programs")
        registry.counter(f"{counter_prefix}/cost_cards_total",
                         help="distinct programs analyzed")

    def needs_count(self, key, program: str) -> bool:
        """Whether the dispatch of ``key`` must run under :func:`counting`
        (its card does not exist yet)."""
        if key in self.cards:
            return False
        return not (len(self.cards) >= self._MAX_CARDS
                    and program in self._program_fallback)

    def add(self, key, program: str, cost: Optional[Cost],
            steps: int) -> CostCard:
        """Make the card of ``key`` from ``cost`` (what its first run
        counted)."""
        with self._lock:
            self.cost_analysis_runs += 1
            card = CostCard.from_cost(cost.as_dict(), program, steps,
                                      self.peak_tflops, self.peak_hbm_gbps)
            self.registry.counter(
                f"{self.counter_prefix}/cost_cards_total").inc()
            self._program_fallback[program] = card
            self.cards[key] = card
            return card

    def note_dispatch(self, key, program: str,
                      cost: Optional[Cost] = None,
                      steps: int = 0) -> Optional[CostCard]:
        """One dispatch of ``key``: its card (made from ``cost`` when
        this was the counted run) added to the counters."""
        card = self.cards.get(key)
        if card is None:
            if cost is not None:
                card = self.add(key, program, cost, steps)
            else:
                card = self._program_fallback.get(program)
        if card is None:
            return None
        prefix = self.counter_prefix
        self.registry.counter(f"{prefix}/flops_total").inc(card.flops)
        if card.bytes_accessed:
            self.registry.counter(f"{prefix}/bytes_total").inc(
                card.bytes_accessed)
        if card.optimal_time_s:
            self.registry.counter(f"{prefix}/optimal_s_total").inc(
                card.optimal_time_s)
        return card

    @contextlib.contextmanager
    def dispatch(self, key, program: str, steps: int = 0):
        """Run one dispatch of ``key`` inside the block: counted when its
        card does not exist yet, then accounted."""
        if not self.needs_count(key, program):
            yield
            self.note_dispatch(key, program, None, steps)
            return
        with counting() as cost:
            yield
        self.note_dispatch(key, program, cost, steps)

    def last_cards(self, n: int = 8) -> List[Dict[str, Any]]:
        """The most recent cards with FLOPs (post-mortem bundles)."""
        return [c.to_dict() for c in list(self.cards.values())[-n:]
                if c.flops]


def signature(tree) -> tuple:
    """The shape signature of a dispatch's inputs: each tensor leaf's shape
    and dtype, other leaves by value."""
    return tuple((tuple(t.shape), str(t.dtype)) if isinstance(t, torch.Tensor)
                 else t for t in tree_leaves(tree))


class AutoCaptureDetector(Detector):
    """A profiler capture the attribution monitor started since the last
    health observation surfaces as an anomaly (action
    ``AttributionConfig.capture_action``)."""

    name = "attribution_capture"

    def __init__(self, monitor: "AttributionMonitor", action: str = "record"):
        super().__init__(action)
        self.monitor = monitor

    def check(self, step, sentinels, ctx) -> Optional[Anomaly]:
        trigger = self.monitor.consume_trigger()
        if trigger is None:
            return None
        return self._fire(
            step,
            f"profiler auto-capture #{trigger['capture']} triggered "
            f"({trigger['reason']}) -> {trigger['trace_dir']}",
            value=trigger.get("value"),
        )


class AttributionMonitor:
    """The cost-card cache, the per-window gauges, the goodput ledger, the
    auto-capture and the ops plane's manual capture (the JAX package's
    ``AttributionMonitor``). A capture is a ``torch.profiler`` trace (CPU
    ops, and CUDA kernels on the card) exported as
    ``stoke.rank<N>.pt.trace.json`` under its directory, the file
    ``Stoke.profile_trace`` writes.

    A manual capture runs on the caller's thread, as the JAX package's
    does: the profiler starts there, the thread sleeps and stops it. On
    the card its trace holds every kernel the process launched meanwhile
    (the training thread's flash kernels too); of the CPU operators it
    holds the caller's thread's only."""

    def __init__(self, cfg, registry, *, trace_dir: Optional[str] = None,
                 rank: int = 0, cuda: bool = False):
        self.cfg = cfg
        self.registry = registry
        self.trace_dir = trace_dir
        self.rank = int(rank)
        self.cuda = bool(cuda)
        self.cost_cards = CostCardCache(registry, cfg.peak_tflops,
                                        cfg.peak_hbm_gbps)
        self._last: Dict[str, float] = {}
        self._goodput_totals: Dict[str, float] = {
            b: 0.0 for b in GOODPUT_BUCKETS}
        self._compile_fresh_total = 0.0
        self._compile_cached_total = 0.0
        self._wall_total = 0.0
        self._flops_recorded = 0.0
        self._windows = 0
        self._step_stats = _RunningStats(cfg.ema_alpha)
        self.captures = 0
        self._capturing = False
        self._capture_stop_at: Optional[int] = None
        self._pending_trigger: Optional[Dict[str, Any]] = None
        self._capture_dirs: List[str] = []
        self._profiler = None
        self._capture_lock = threading.Lock()
        for b in GOODPUT_BUCKETS:
            registry.counter(f"goodput/{b}_s_total", help=f"wall seconds: {b}")
        registry.counter("goodput/compile_fresh_s_total",
                         help="compile-bucket seconds from fresh compiles")
        registry.counter("goodput/compile_cached_s_total",
                         help="compile-bucket seconds from cache loads")

    def _delta(self, name: str) -> float:
        inst = self.registry.get(name)
        now = inst.value if inst is not None else 0.0
        prev = self._last.get(name, 0.0)
        self._last[name] = now
        return max(0.0, now - prev)

    def window_stats(self, *, step: int, wall_s: Optional[float],
                     host_dispatch_s: float, loader_wait_s: float,
                     ckpt_io_s: float,
                     comm_bytes_onwire: Optional[float]) -> Dict[str, Any]:
        """One window's attribution fields (achieved_tflops / mfu /
        hbm_bw_util / bound / goodput_*) from the counters' deltas. The
        port's compiles are its kernel builds and window captures
        (``cuda/compile_time_s``, ``cuda/recompiles_total``), the fresh
        share; the cached share is what a ``CompileConfig``'s hits paid,
        the loads of the cached kernel libraries
        (``compile_cache/hit_s_total``), as the JAX monitor splits
        them."""
        flops = self._delta("attr/flops_total")
        bytes_acc = self._delta("attr/bytes_total")
        compile_fresh_dt = self._delta("cuda/compile_time_s")
        compile_cached_dt = self._delta("compile_cache/hit_s_total")
        compile_dt = compile_fresh_dt + compile_cached_dt
        recompiles_dt = self._delta("cuda/recompiles_total")
        halt_dt = self._delta("health/halt_s")
        out: Dict[str, Any] = {
            "achieved_tflops": None, "mfu": None, "hbm_bw_util": None,
            "bound": None, "goodput_compile_fresh_s": None,
            "goodput_compile_cached_s": None,
        }
        for b in GOODPUT_BUCKETS:
            out[f"goodput_{b}_s"] = None
        if wall_s is None or wall_s <= 0:
            return out
        rl = roofline_summary(flops, wall_s, self.cfg.peak_tflops)
        out["achieved_tflops"] = rl["achieved_tflops"]
        out["mfu"] = rl["mfu"]
        if bytes_acc and self.cfg.peak_hbm_gbps > 0:
            out["hbm_bw_util"] = (bytes_acc / wall_s
                                  / (self.cfg.peak_hbm_gbps * 1e9))
        comm_s = None
        if comm_bytes_onwire and self.cfg.ici_gbps > 0:
            comm_s = comm_bytes_onwire / (self.cfg.ici_gbps * 1e9)
        compute_s = (flops / (self.cfg.peak_tflops * 1e12)
                     if self.cfg.peak_tflops > 0 else None)
        memory_s = (bytes_acc / (self.cfg.peak_hbm_gbps * 1e9)
                    if bytes_acc and self.cfg.peak_hbm_gbps > 0 else None)
        # the facade's phase timers include the device work wherever the
        # host waits for it (the CPU, the readbacks), so a synchronous run
        # reads "host", as the JAX package's does on its CPU backend
        out["bound"] = classify_bound(
            wall_s=wall_s, compute_optimal_s=compute_s,
            memory_optimal_s=memory_s, comm_s=comm_s,
            host_s=loader_wait_s + host_dispatch_s)
        overheads = {
            "compile": compile_dt if recompiles_dt == 0 else 0.0,
            "recompile": compile_dt if recompiles_dt > 0 else 0.0,
            "loader": loader_wait_s,
            "checkpoint": ckpt_io_s,
            "halt": halt_dt,
        }
        total_over = sum(overheads.values())
        if total_over > wall_s > 0:
            scale = wall_s / total_over
            overheads = {k: v * scale for k, v in overheads.items()}
            total_over = wall_s
        buckets = {"productive": max(0.0, wall_s - total_over), **overheads}
        for b, v in buckets.items():
            out[f"goodput_{b}_s"] = v
            self._goodput_totals[b] += v
            self.registry.counter(f"goodput/{b}_s_total").inc(v)
        accounted = overheads["compile"] + overheads["recompile"]
        frac = accounted / compile_dt if compile_dt > 0 else 0.0
        fresh = compile_fresh_dt * frac
        cached = compile_cached_dt * frac
        out["goodput_compile_fresh_s"] = fresh
        out["goodput_compile_cached_s"] = cached
        self._compile_fresh_total += fresh
        self._compile_cached_total += cached
        self.registry.counter("goodput/compile_fresh_s_total").inc(fresh)
        self.registry.counter("goodput/compile_cached_s_total").inc(cached)
        self._wall_total += wall_s
        self._flops_recorded += flops
        self._windows += 1
        self.registry.gauge("attr/mfu").set(out["mfu"] or 0.0)
        self.registry.gauge("attr/achieved_tflops").set(
            out["achieved_tflops"] or 0.0)
        self._maybe_trigger_capture(step, out["mfu"], wall_s)
        return out

    def goodput_summary(self) -> Dict[str, Any]:
        """Cumulative goodput: seconds and share per bucket, aggregate
        achieved TFLOP/s and MFU, the captures."""
        wall = self._wall_total
        out: Dict[str, Any] = {
            "wall_s": wall,
            "windows": self._windows,
            "goodput_fraction": (self._goodput_totals["productive"] / wall
                                 if wall > 0 else None),
        }
        for b in GOODPUT_BUCKETS:
            out[f"{b}_s"] = self._goodput_totals[b]
        out["compile_fresh_s"] = self._compile_fresh_total
        out["compile_cached_s"] = self._compile_cached_total
        out["compile_saved_s"] = 0.0
        if wall > 0:
            out.update(roofline_summary(self._flops_recorded, wall,
                                        self.cfg.peak_tflops))
        out["captures"] = self.captures
        out["capture_dirs"] = list(self._capture_dirs)
        return out

    # ------------------------------------------------------------------ #
    # anomaly-triggered profiler capture
    # ------------------------------------------------------------------ #

    def _maybe_trigger_capture(self, step: int, mfu: Optional[float],
                               wall_s: float) -> None:
        cfg = self.cfg
        z = self._step_stats.zscore(wall_s)
        warm = self._step_stats.count >= cfg.capture_warmup_windows
        self._step_stats.update(wall_s)
        if not cfg.auto_capture or self._capturing:
            return
        if self.captures >= cfg.max_captures:
            return
        reason = value = None
        if (warm and cfg.capture_step_zscore > 0 and z is not None
                and z > cfg.capture_step_zscore):
            reason, value = f"step-time z={z:.1f}", wall_s
        elif (warm and cfg.capture_mfu_below > 0 and mfu is not None
              and mfu < cfg.capture_mfu_below):
            reason, value = f"mfu {mfu:.4f} < {cfg.capture_mfu_below}", mfu
        if reason is None:
            return
        self._start_capture(step, reason, value)

    def _start_capture(self, step: int, reason: str, value) -> None:
        if self.trace_dir is None:
            return
        safe = "".join(c if (c.isalnum() or c in "-_=.") else "-"
                       for c in reason)[:48]
        with self._capture_lock:
            if self._capturing:
                return
            target = os.path.join(
                self.trace_dir,
                f"auto-capture-{self.captures + 1}-step{step}-{safe}")
            try:
                self._open_profiler(target)
            except Exception as e:  # a profiler cannot kill the run
                warnings.warn(f"Stoke -- attribution auto-capture failed to "
                              f"start: {e!r}")
                return
            self._count_capture(target)
            self._capturing = True
            self._capture_stop_at = step + max(1, self.cfg.capture_steps)
        self._pending_trigger = {
            "capture": self.captures, "reason": reason,
            "value": None if value is None else float(value),
            "trace_dir": target, "step": step,
        }

    def on_step(self, optimizer_steps: int) -> None:
        """Every step boundary: close an auto-capture once it covered
        ``capture_steps`` steps (a manual capture stops itself)."""
        with self._capture_lock:
            if self._capturing and self._capture_stop_at is not None \
                    and optimizer_steps >= self._capture_stop_at:
                self._stop_capture()

    def _open_profiler(self, target: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._profiler = (prof, target)

    def _count_capture(self, target: str) -> None:
        """Only a trace that started takes a slot of the budget."""
        self.captures += 1
        self._capture_dirs.append(target)
        self.registry.counter("attr/captures_total",
                              help="anomaly-triggered profiler captures").inc()

    def manual_capture(self, seconds: float,
                       reason: str = "manual") -> Dict[str, Any]:
        """One bounded on-demand capture (the ops plane's ``/profile``):
        the profiler starts, this thread sleeps ``seconds`` while the run
        goes on, and stops it. On the budget of ``max_captures`` and
        exclusive with the auto-capture. Returns ``{"ok": True,
        "trace_dir", "seconds", "captures", "max_captures"}`` or ``{"ok":
        False, "error"}`` (the error names the budget or a capture in
        flight where those refuse it)."""
        if self.trace_dir is None:
            return {"ok": False,
                    "error": "no trace_dir — set ProfilerConfig.trace_dir "
                             "to enable on-demand capture"}
        safe = "".join(c if (c.isalnum() or c in "-_=.") else "-"
                       for c in reason)[:48]
        seconds = max(0.0, float(seconds))
        with self._capture_lock:
            if self._capturing:
                return {"ok": False, "error": "capture already in flight"}
            if self.captures >= self.cfg.max_captures:
                return {"ok": False,
                        "error": f"capture budget exhausted "
                                 f"({self.captures}/{self.cfg.max_captures})"}
            target = os.path.join(
                self.trace_dir, f"manual-capture-{self.captures + 1}-{safe}")
            try:
                self._open_profiler(target)
            except Exception as e:
                return {"ok": False,
                        "error": f"profiler failed to start: {e!r}"}
            self._count_capture(target)
            self._capturing = True
            self._capture_stop_at = None
        time.sleep(seconds)
        with self._capture_lock:
            self._stop_capture()
        return {"ok": True, "trace_dir": target, "seconds": seconds,
                "captures": self.captures,
                "max_captures": self.cfg.max_captures}

    def _stop_capture(self) -> None:
        prof, target = self._profiler or (None, None)
        self._profiler = None
        self._capturing = False
        self._capture_stop_at = None
        if prof is None:
            return
        try:
            prof.stop()
            os.makedirs(target, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                target, f"stoke.rank{self.rank}.pt.trace.json"))
        except Exception as e:
            warnings.warn(f"Stoke -- attribution auto-capture export "
                          f"failed: {e!r}")

    def consume_trigger(self) -> Optional[Dict[str, Any]]:
        """One-shot read of the latest capture trigger."""
        t, self._pending_trigger = self._pending_trigger, None
        return t

    def close(self) -> None:
        with self._capture_lock:
            if self._capturing:
                self._stop_capture()
