"""Structured host tracing: a bounded span ring, one composed span
helper, Perfetto export, and a critical-path summary.

The port's copy of ``stoke_tpu/telemetry/tracing.py``: the same ring,
nesting and self-time bookkeeping, ``summary()``, and trace-event JSON
(which ``scripts/merge_rank_traces.py`` merges across ranks). The one
difference is the profiler annotation each span also opens:
``torch.profiler.record_function`` (:func:`~stoke_tpu_torch.telemetry
.collectors.xprof_span`), which names the section in a ``torch.profiler``
trace and, under ``nsys``, as an NVTX range.

1. :class:`TraceRecorder` — a bounded ring of completed host spans
   ``(name, track, t_start, dur, self, step, request_id, parent_id,
   attrs)`` recorded from ``perf_counter`` pairs.  O(1) per span, no IO,
   no device touches; per-span self-time (duration minus child durations)
   is maintained incrementally on a thread-local open-span stack, so the
   critical-path summary never has to rebuild the tree.
2. :func:`trace_span` — ONE composed context manager emitting the profiler
   annotation AND a host span into every registered recorder (plus an
   optional registry timer).  With no recorder registered it degrades to
   the bare annotation.
3. Chrome/Perfetto trace-event export (``trace.rank<N>.json``): ``"X"``
   duration events on per-track (and per-request) threads, loadable in
   ``ui.perfetto.dev`` / ``chrome://tracing``;
   ``scripts/merge_rank_traces.py`` aligns multiple ranks' files by step
   anchor into one timeline.

Recorder registration is module-global: the engine/data/io/serving layers
call :func:`trace_span` with no plumbing, and whichever facade holds an
active ``TraceConfig`` receives the spans.  Default OFF — without a
registered recorder no ring exists, and the device work is the same
either way (tracing is purely host-side).
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from stoke_tpu_torch.telemetry.collectors import xprof_span

#: keys every exported ``"X"`` duration event carries (the
#: Perfetto/chrome-trace minimum; tests pin the schema)
TRACE_EVENT_KEYS = ("name", "ph", "ts", "dur", "pid", "tid")

# --------------------------------------------------------------------------- #
# module-global recorder registry
# --------------------------------------------------------------------------- #

_RECORDERS: "weakref.WeakSet[TraceRecorder]" = weakref.WeakSet()


def register_recorder(recorder: "TraceRecorder") -> None:
    """Subscribe a recorder to every :func:`trace_span` /
    :func:`trace_point` site in the process (idempotent).  Kept weak — a
    dropped facade must not leak its ring forever."""
    _RECORDERS.add(recorder)


def unregister_recorder(recorder: "TraceRecorder") -> None:
    """Stop routing spans to ``recorder`` (idempotent)."""
    _RECORDERS.discard(recorder)


# --------------------------------------------------------------------------- #
# spans
# --------------------------------------------------------------------------- #


class Span:
    """One completed host span (immutable once ringed)."""

    __slots__ = (
        "span_id", "parent_id", "name", "track", "t_start", "dur_s",
        "self_s", "step", "request_id", "attrs",
    )

    def __init__(self, span_id, parent_id, name, track, t_start, dur_s,
                 self_s, step, request_id, attrs):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.track = track
        self.t_start = t_start
        self.dur_s = dur_s
        self.self_s = self_s
        self.step = step
        self.request_id = request_id
        self.attrs = attrs

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "span_id": self.span_id,
            "name": self.name,
            "track": self.track,
            "t_start": self.t_start,
            "dur_s": self.dur_s,
            "self_s": self.self_s,
            "step": self.step,
        }
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        if self.request_id is not None:
            out["request_id"] = self.request_id
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out


class _OpenSpan:
    """Stack entry for an in-flight span (thread-local; never shared)."""

    __slots__ = ("span_id", "parent_id", "name", "track", "request_id",
                 "attrs", "t0", "child_s")

    def __init__(self, span_id, parent_id, name, track, request_id, attrs):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.track = track
        self.request_id = request_id
        self.attrs = attrs
        self.t0 = 0.0
        self.child_s = 0.0


class _SpanCtx:
    """Context manager recording one span into its recorder on exit."""

    __slots__ = ("_rec", "_name", "_track", "_rid", "_attrs", "_open")

    def __init__(self, rec, name, track, request_id, attrs):
        self._rec = rec
        self._name = name
        self._track = track
        self._rid = request_id
        self._attrs = attrs

    def __enter__(self):
        self._open = self._rec._push(
            self._name, self._track, self._rid, self._attrs
        )
        # last so the span never times its own bookkeeping
        self._open.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()  # first, same reason
        self._rec._pop(self._open, t1)
        return False


class TraceRecorder:
    """Bounded ring of host spans + Perfetto exporter + summary.

    Thread-safe: the serving loop, loader generators, and the training
    thread may all record concurrently (nesting is tracked per thread).
    Ring appends are O(1); a full ring evicts oldest-first and counts the
    eviction (``dropped`` / ``trace/dropped_total``) — a long run's ring
    is the *recent* window, which is what a post-mortem wants anyway.
    """

    def __init__(
        self,
        config=None,
        *,
        rank: int = 0,
        registry=None,
        ring_size: Optional[int] = None,
        output_dir: Optional[str] = None,
    ):
        self.config = config
        self.rank = int(rank)
        if ring_size is None:
            ring_size = config.ring_size if config is not None else 4096
        self.output_dir = (
            output_dir
            if output_dir is not None
            else (config.output_dir if config is not None else "trace")
        )
        self._ring: "deque[Span]" = deque(maxlen=int(ring_size))
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._next_id = 0
        self._step = 0
        self.dropped = 0
        self._registry = registry
        # counter handles cached here: the record path must be plain
        # .inc() calls, not name lookups through the registry lock (the
        # serving loop, loader threads, and the training thread all
        # record concurrently — and the <1% overhead claim rides on it)
        self._spans_counter = self._dropped_counter = None
        self._track_counters: Dict[str, Any] = {}
        if registry is not None:
            # pre-register so snapshots carry zeros before the first span
            self._spans_counter = registry.counter(
                "trace/spans_total", help="host trace spans recorded"
            )
            self._dropped_counter = registry.counter(
                "trace/dropped_total",
                help="spans evicted from the bounded trace ring",
            )
        # wall-clock anchor: perf_counter origin is arbitrary, so the
        # export stamps both clocks at construction — readers (and the
        # rank merger) can map span ts to wall time
        self._anchor_wall = time.time()
        self._anchor_perf = time.perf_counter()

    # ------------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------------ #

    def set_step(self, step: int) -> None:
        """Tag subsequently recorded spans with ``step`` (the facade sets
        the last completed optimizer step at each boundary)."""
        self._step = int(step)

    @property
    def step(self) -> int:
        return self._step

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def span(self, name: str, *, track: str = "host",
             request_id=None, attrs=None) -> _SpanCtx:
        """Context manager timing one span into the ring."""
        return _SpanCtx(self, name, track, request_id, attrs)

    def _push(self, name, track, request_id, attrs) -> _OpenSpan:
        stack = self._stack()
        parent_id = stack[-1].span_id if stack else None
        with self._lock:
            self._next_id += 1
            span_id = self._next_id
        entry = _OpenSpan(span_id, parent_id, name, track, request_id, attrs)
        stack.append(entry)
        return entry

    def _pop(self, entry: _OpenSpan, t1: float) -> None:
        stack = self._stack()
        # tolerate exit-order surprises (a generator span closed by GC on
        # another frame): unwind to the entry rather than corrupt nesting
        while stack and stack[-1] is not entry:
            stack.pop()
        if stack:
            stack.pop()
        dur = max(t1 - entry.t0, 0.0)
        self_s = max(dur - entry.child_s, 0.0)
        if stack:
            stack[-1].child_s += dur
        self._record(Span(
            entry.span_id, entry.parent_id, entry.name, entry.track,
            entry.t0, dur, self_s, self._step, entry.request_id,
            entry.attrs,
        ))

    def add(self, name: str, t_start: float, t_end: float, *,
            track: str = "host", request_id=None, step=None,
            attrs=None, count_self: bool = True) -> None:
        """Record an explicit ``perf_counter`` interval (no nesting
        participation) — the serving path uses this for admission waits
        and per-request decode slices whose brackets are not lexical.

        ``count_self=False`` records the span with zero self-time: the
        per-request timeline slices deliberately OVERLAP each other (all
        live requests ride one batch decode interval) and the spans that
        already own that wall clock — charging them too would multiply-
        count the window in the critical-path summary and the
        ``trace/<track>_self_s`` counters."""
        with self._lock:
            self._next_id += 1
            span_id = self._next_id
        dur = max(float(t_end) - float(t_start), 0.0)
        self._record(Span(
            span_id, None, name, track, float(t_start), dur,
            dur if count_self else 0.0,
            self._step if step is None else int(step), request_id, attrs,
        ))

    def point(self, name: str, *, track: str = "host", request_id=None,
              attrs=None) -> None:
        """Record a zero-duration marker span (eviction, arrivals)."""
        now = time.perf_counter()
        self.add(name, now, now, track=track, request_id=request_id,
                 attrs=attrs)

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
                dropped = True
            else:
                dropped = False
            self._ring.append(span)
        if self._registry is not None:
            self._spans_counter.inc()
            if dropped:
                self._dropped_counter.inc()
            # per-track self-seconds: tracks are a small closed set
            # (facade/step/data/io/serve), so cardinality stays bounded
            # and the handle cache stays tiny
            track_counter = self._track_counters.get(span.track)
            if track_counter is None:
                track_counter = self._registry.counter(
                    f"trace/{span.track}_self_s"
                )
                self._track_counters[span.track] = track_counter
            track_counter.inc(span.self_s)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def summary(self, top: int = 10) -> Dict[str, Any]:
        """Critical-path/self-time summary of the ring window.

        Host spans on one thread are serial, so total wall is (to ring
        resolution) the sum of self-times — the top self-time entries ARE
        the host critical path.  Returns per-name totals plus the ranked
        ``critical_path`` list.
        """
        spans = self.spans()
        # aggregate by (name, track): the same name can appear on several
        # tracks ("stoke/step" is both the facade phase and the engine
        # apply dispatch; "stoke/io" both loader fetch and checkpoint
        # IO) and merging them would mislabel the critical path
        agg_by_key: Dict[tuple, Dict[str, Any]] = {}
        for s in spans:
            agg = agg_by_key.setdefault(
                (s.name, s.track),
                {"count": 0, "total_s": 0.0, "self_s": 0.0,
                 "track": s.track},
            )
            agg["count"] += 1
            agg["total_s"] += s.dur_s
            agg["self_s"] += s.self_s
        # display labels: the bare name when it is track-unique, else
        # "name [track]" so no two rows collide
        name_tracks: Dict[str, set] = {}
        for name, track in agg_by_key:
            name_tracks.setdefault(name, set()).add(track)
        by_name = {
            (name if len(name_tracks[name]) == 1 else f"{name} [{track}]"):
                agg
            for (name, track), agg in agg_by_key.items()
        }
        total_self = sum(a["self_s"] for a in by_name.values())
        ranked = sorted(
            by_name.items(), key=lambda kv: -kv[1]["self_s"]
        )[:max(int(top), 0)]
        return {
            "spans": len(spans),
            "dropped": self.dropped,
            # registry-name alias: a truncated ring must not
            # masquerade as a complete critical path — dashboards keyed on
            # the counter name read the same figure off the summary
            "trace/dropped_total": self.dropped,
            "tracks": sorted({s.track for s in spans}),
            "window_self_s": total_self,
            "by_name": by_name,
            "critical_path": [
                {
                    "name": name,
                    "track": agg["track"],
                    "count": agg["count"],
                    "self_s": agg["self_s"],
                    "frac": (agg["self_s"] / total_self) if total_self else 0.0,
                }
                for name, agg in ranked
            ],
        }

    # ------------------------------------------------------------------ #
    # Chrome/Perfetto export
    # ------------------------------------------------------------------ #

    def to_trace_events(self) -> List[Dict[str, Any]]:
        """The ring as chrome-trace events: one ``"X"`` duration event per
        span on a per-track thread (requests get their own
        ``serve/req<id>`` thread — the per-request timeline), preceded by
        ``"M"`` process/thread-name metadata."""
        spans = self.spans()
        tids: Dict[str, int] = {}

        def tid_for(label: str) -> int:
            if label not in tids:
                tids[label] = len(tids) + 1
            return tids[label]

        events: List[Dict[str, Any]] = []
        for s in spans:
            label = (
                f"{s.track}/req{s.request_id}"
                if s.request_id is not None
                else s.track
            )
            args: Dict[str, Any] = {"step": s.step, "span_id": s.span_id}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            if s.request_id is not None:
                args["request_id"] = s.request_id
            if s.attrs:
                args.update(s.attrs)
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": s.t_start * 1e6,
                "dur": s.dur_s * 1e6,
                "pid": self.rank,
                "tid": tid_for(label),
                "args": args,
            })
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": self.rank, "tid": 0,
            "args": {"name": f"stoke rank{self.rank}"},
        }]
        for label, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": self.rank,
                "tid": tid, "args": {"name": label},
            })
        return meta + events

    def export(self, path: Optional[str] = None) -> str:
        """Write ``trace.rank<N>.json`` (chrome-trace JSON object format);
        returns the path.  Every rank writes its own file — the merge tool
        aligns them by step anchor."""
        if path is None:
            os.makedirs(self.output_dir, exist_ok=True)
            path = os.path.join(self.output_dir, f"trace.rank{self.rank}.json")
        doc = {
            "traceEvents": self.to_trace_events(),
            "displayTimeUnit": "ms",
            "stoke": {
                "rank": self.rank,
                "dropped": self.dropped,
                "anchor_wall_s": self._anchor_wall,
                "anchor_perf_s": self._anchor_perf,
            },
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        os.replace(tmp, path)
        return path


# --------------------------------------------------------------------------- #
# the composed span helper (subsumes the old telemetry._ComposedContext)
# --------------------------------------------------------------------------- #


class ComposedContext:
    """Enter/exit a sequence of context managers as one (annotation +
    host span + timer)."""

    __slots__ = ("_cms",)

    def __init__(self, *cms):
        self._cms = cms

    def __enter__(self):
        for cm in self._cms:
            cm.__enter__()
        return self

    def __exit__(self, *exc):
        result = False
        for cm in reversed(self._cms):
            if cm.__exit__(*exc):
                result = True
        return result


def trace_span(
    name: str,
    *,
    track: str = "host",
    request_id=None,
    attrs: Optional[Dict[str, Any]] = None,
    annotate: bool = True,
    timer=None,
):
    """THE span primitive every timed section routes through: opens the
    profiler annotation (when ``annotate``), a host span into every
    registered :class:`TraceRecorder`, and accumulates ``timer`` (a
    registry ``_Timer``) — one context manager instead of three
    hand-rolled pairings.  With no recorder registered and no timer it
    returns the bare annotation: exactly the pre-tracing call sites'
    behavior and cost."""
    recs = list(_RECORDERS) if _RECORDERS else ()
    cms: List[Any] = []
    if annotate:
        cms.append(xprof_span(name))
    for rec in recs:
        cms.append(rec.span(name, track=track, request_id=request_id,
                            attrs=attrs))
    if timer is not None:
        cms.append(timer)
    if len(cms) == 1:
        return cms[0]
    return ComposedContext(*cms)


def trace_point(name: str, *, track: str = "host", request_id=None,
                attrs: Optional[Dict[str, Any]] = None) -> None:
    """Zero-duration marker into every registered recorder (no-op when
    none is registered — the default-OFF fast path)."""
    if not _RECORDERS:
        return
    for rec in list(_RECORDERS):
        rec.point(name, track=track, request_id=request_id, attrs=attrs)


def trace_add(name: str, t_start: float, t_end: float, *,
              track: str = "host", request_id=None,
              attrs: Optional[Dict[str, Any]] = None,
              count_self: bool = True) -> None:
    """Explicit ``perf_counter`` interval into every registered recorder
    (no-op when none is registered).  ``count_self=False`` for timeline
    spans that overlap wall clock another span already owns."""
    if not _RECORDERS:
        return
    for rec in list(_RECORDERS):
        rec.add(name, t_start, t_end, track=track, request_id=request_id,
                attrs=attrs, count_self=count_self)


def tracing_active() -> bool:
    """True when at least one recorder is registered (serving uses this to
    skip per-request slice bookkeeping entirely when tracing is off)."""
    return bool(_RECORDERS)


def request_spans(request_id) -> List[Span]:
    """Every ringed span tagged with ``request_id`` across the registered
    recorders — the JAX package's SLO violation attribution re-walks a
    finished request's timeline through this.  Empty when tracing is off
    (the attribution then reports span coverage ``"none"``, never a
    vacuously-complete walk)."""
    if not _RECORDERS:
        return []
    out: List[Span] = []
    for rec in list(_RECORDERS):
        out.extend(s for s in rec.spans() if s.request_id == request_id)
    return out


def dropped_total() -> int:
    """Spans evicted across the registered recorders' rings.  Nonzero
    means any span-derived walk (critical path, SLO attribution) may be
    missing intervals and must report itself partial."""
    return sum(rec.dropped for rec in list(_RECORDERS))
