"""Cross-process sync timing: the always-on part of the JAX package's
``stoke_tpu/telemetry/fleet.py`` (``:270-330``).

Every ``Telemetry`` registers its registry here, and ``Stoke.barrier`` and
the checkpoint syncs (:mod:`stoke_tpu_torch.io_ops`) time their waits into
``sync/barrier_wait_s`` / ``sync/barriers_total`` (and ``sync/<tag>_wait_s``
per source) of every live registry, with or without a ``FleetConfig``.
The fleet monitor itself (the cross-host signal exchange and straggler
detection) is ROADMAP Queue 1 item 10d.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Optional

#: live telemetry registries receiving cross-process sync timings; a
#: WeakSet so a dropped Telemetry/Stoke never leaks its registry here
_SYNC_REGISTRIES: "weakref.WeakSet" = weakref.WeakSet()


def unregister_sync_registry(registry) -> None:
    """Unsubscribe a registry from sync timings (``Telemetry.close``
    calls this — a closed run's counters must not keep accruing later
    runs' barrier waits into its post-run summary).  Idempotent."""
    _SYNC_REGISTRIES.discard(registry)


def register_sync_registry(registry) -> None:
    """Subscribe a metrics registry to cross-process sync timings (every
    ``Telemetry`` registers its registry at construction).  Idempotent."""
    _SYNC_REGISTRIES.add(registry)
    # pre-register so scrapes/breakdowns carry zeros before the first sync
    registry.counter(
        "sync/barrier_wait_s",
        help="host seconds spent inside cross-process barriers "
        "(Stoke.barrier + checkpoint sync_global_devices)",
    )
    registry.counter(
        "sync/barriers_total", help="cross-process barrier crossings"
    )


def observe_sync_wait(seconds: float, tag: Optional[str] = None) -> None:
    """Record one completed cross-process sync into every live registry:
    the aggregate ``sync/barrier_wait_s`` / ``sync/barriers_total`` pair
    always, plus a per-source ``sync/<tag>_wait_s`` when the caller names
    one. Process-scoped by design: concurrent Stoke instances in one
    process each see the process's total sync time."""
    seconds = max(float(seconds), 0.0)
    for registry in list(_SYNC_REGISTRIES):
        registry.counter("sync/barrier_wait_s").inc(seconds)
        registry.counter("sync/barriers_total").inc()
        if tag:
            registry.counter(f"sync/{tag}_wait_s").inc(seconds)


@contextlib.contextmanager
def timed_sync(tag: Optional[str] = None):
    """Bracket a cross-process sync: the elapsed host wall time — the
    barrier wait, near zero for the last arrival and the full skew for the
    first — lands in ``sync/barrier_wait_s`` (and ``sync/<tag>_wait_s``)
    of every registered registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        observe_sync_wait(time.perf_counter() - t0, tag)
