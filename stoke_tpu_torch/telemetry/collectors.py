"""Cross-cutting collectors: compile tracking, device-memory watermarks and
labelled profiler spans.

The port's counterpart of ``stoke_tpu/telemetry/collectors.py``:

- :class:`CompileTracker` counts what the port compiles. XLA compiles
  every jitted program; the port compiles only two things: the first-use
  ``nvcc`` build of a kernel source (``ops/_build.py``) and the CUDA-graph
  capture of a training window (``StepEngine._capture``). Both report
  through :func:`note_compile` (module-global: a build serves every run
  in the process) to every live tracker. A window captured again for a
  signature or learning rate it had captured before is a recompile, which
  the owning engine reports to its own tracker with
  :meth:`CompileTracker.note_recompile` (a per-window learning-rate
  schedule captures every window: a real recompile storm in the port).
- :func:`hbm_stats` / :func:`update_hbm_gauges` read
  ``torch.cuda.memory_stats`` and ``mem_get_info`` into the JAX package's
  ``memory_stats()`` keys; None on the CPU, as the JAX package reports
  nothing off the TPU.
- :func:`xprof_span` is ``torch.profiler.record_function``: the section is
  named in a ``torch.profiler`` trace (and as an NVTX range under
  ``nsys``). :func:`set_xprof_enabled` turns the annotations off
  process-wide.

Trackers are kept in a ``WeakSet``: a dropped ``Telemetry`` object does
not leak its tracker.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Dict, Iterator, Optional

_trackers: "weakref.WeakSet[CompileTracker]" = weakref.WeakSet()
#: health monitors whose hang watchdog a compile extends
_watchers: "weakref.WeakSet" = weakref.WeakSet()


def note_compile(duration: float) -> None:
    """Report one compile (a kernel build or a window capture) of
    ``duration`` seconds to every live tracker."""
    for tracker in list(_trackers):
        tracker._on_compile(duration)


def watch_compiles(monitor) -> None:
    """Have every compile from now on call ``monitor.extend_for_compile()``
    as it starts (a health monitor's watchdog grace)."""
    _watchers.add(monitor)


def unwatch_compiles(monitor) -> None:
    _watchers.discard(monitor)


def compile_starting() -> None:
    """A kernel build or a window capture is starting: extend the armed
    watchdogs' deadlines by their compile grace."""
    for monitor in list(_watchers):
        monitor.extend_for_compile()


@contextlib.contextmanager
def compiling() -> Iterator[None]:
    """One compile inside the block: :func:`compile_starting` on entry,
    :func:`note_compile` with its seconds on a normal exit."""
    compile_starting()
    t0 = time.perf_counter()
    yield
    note_compile(time.perf_counter() - t0)


class CompileTracker:
    """Per-``Telemetry`` compile accounting.

    - ``compiles`` / ``compile_time_s``: every kernel build and window
      capture observed since construction (fed by :func:`note_compile`).
    - ``recompiles``: windows captured again for a signature already
      captured once, reported by the owning facade's engine via
      :meth:`note_recompile` (instance-scoped: another facade's captures
      are not charged here).
    """

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self.compiles = 0
        self.compile_time_s = 0.0
        self.recompiles = 0
        self._registry = registry
        if registry is not None:
            # pre-register so snapshots carry zeros before the first compile
            registry.counter(
                "cuda/compiles_total",
                help="kernel builds and CUDA-graph captures observed",
            )
            registry.counter(
                "cuda/compile_time_s",
                help="cumulative kernel build and capture seconds",
            )
            registry.counter(
                "cuda/recompiles_total",
                help="training windows captured again for a signature "
                "captured before",
            )
        _trackers.add(self)

    def _on_compile(self, duration: float) -> None:
        with self._lock:
            self.compiles += 1
            self.compile_time_s += float(duration)
        if self._registry is not None:
            self._registry.counter("cuda/compiles_total").inc()
            self._registry.counter("cuda/compile_time_s").inc(float(duration))

    def note_recompile(self, n: int = 1) -> None:
        """Record ``n`` recompiles (a window captured again)."""
        with self._lock:
            self.recompiles += int(n)
        if self._registry is not None:
            self._registry.counter("cuda/recompiles_total").inc(int(n))


# --------------------------------------------------------------------------- #
# device-memory high-watermark gauges
# --------------------------------------------------------------------------- #

#: memory_stats keys -> registry gauge names (the JAX package's)
_HBM_KEYS = {
    "bytes_in_use": "hbm/bytes_in_use",
    "peak_bytes_in_use": "hbm/peak_bytes",
    "bytes_limit": "hbm/bytes_limit",
    "largest_free_block_bytes": "hbm/largest_free_block_bytes",
}


def hbm_stats(device=None) -> Optional[Dict[str, int]]:
    """The JAX ``memory_stats()`` keys of a CUDA device (default: the
    current one): ``bytes_in_use`` and ``peak_bytes_in_use`` from the
    caching allocator's allocated bytes, ``bytes_limit`` the card's total
    memory, ``largest_free_block_bytes`` the free memory
    ``torch.cuda.mem_get_info`` reports. None without a CUDA device."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        if device is not None and torch.device(device).type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
        free, total = torch.cuda.mem_get_info(device)
    except Exception:
        return None
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
        "largest_free_block_bytes": int(free),
    }


def update_hbm_gauges(registry, device=None) -> Optional[Dict[str, int]]:
    """Refresh the ``hbm/*`` gauges from :func:`hbm_stats`; returns the raw
    stats (None on the CPU, gauges left unset)."""
    stats = hbm_stats(device)
    if not stats:
        return None
    for key, gauge_name in _HBM_KEYS.items():
        if key in stats:
            registry.gauge(gauge_name).set(stats[key])
    return stats


# --------------------------------------------------------------------------- #
# labelled profiler spans
# --------------------------------------------------------------------------- #

_xprof_enabled = True


def set_xprof_enabled(enabled: bool) -> None:
    """Process-wide toggle for the phase annotations (on by default)."""
    global _xprof_enabled
    _xprof_enabled = bool(enabled)


def xprof_span(name: str):
    """Context manager naming the enclosed host section in a
    ``torch.profiler`` trace (``torch.profiler.record_function``); a
    null context when disabled."""
    if not _xprof_enabled:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)
