"""Live ops plane: a scrapeable, read-only HTTP observatory (the port's
copy of ``stoke_tpu/telemetry/opsplane.py``).

Stdlib only (``http.server.ThreadingHTTPServer``), GET only (any other
method is answered 405), and off without an ``OpsPlaneConfig``: then no
thread starts and no socket binds. With one, the plane adds no step-event
field and no launch: it reads state the other subsystems keep.

Endpoints (JSON unless noted):

- ``/metrics``: the Prometheus text exposition, rendered by the same
  :func:`~stoke_tpu_torch.telemetry.sinks.render_prometheus` and with the
  same labels as the run's ``PrometheusSink``, so the scrape file and the
  endpoint agree byte for byte on one snapshot.
- ``/healthz``: 200 while serviceable, 503 once the health monitor halted
  (``HealthMonitor.halted``), the drain signal of a load balancer.
- ``/statusz``: one object whose top-level keys are :data:`STATUSZ_FIELDS`
  (the JAX package's, in its order): identity, health, the training
  goodput / memory / trace summaries and the serving engine's
  ``summary()``.
- ``/requests``: the serving engine's in-flight table: rid, priority,
  state (queued / prefilling / decoding), tokens out, KV blocks held,
  TTFT headroom.
- ``/trace``: the span ring as Chrome / Perfetto trace events.
- ``/profile?seconds=N``: one bounded ``torch.profiler`` capture into
  ``ProfilerConfig.trace_dir`` through
  :meth:`~stoke_tpu_torch.telemetry.attribution.AttributionMonitor.manual_capture`,
  on the budget of ``AttributionConfig.max_captures``: 429 once it is
  spent, 409 while a capture is in flight. The capture runs on the
  request's thread, as the JAX plane's does: on the card the trace holds
  every kernel the run launched meanwhile, of the CPU operators only that
  thread's.

Across processes every rank binds ``cfg.port + rank`` (loopback by
default); ``port=0`` binds an ephemeral port and :attr:`OpsPlane.port`
reports it.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from stoke_tpu_torch.telemetry.sinks import (
    PrometheusSink,
    host_labels,
    render_prometheus,
)

#: The top-level key set of the ``/statusz`` object (the JAX package's, a
#: wire format: appended to, never reordered or removed). Every key is
#: always present; an absent subsystem renders as null.
STATUSZ_FIELDS = (
    "rank",
    "host",
    "port",
    "run",
    "uptime_s",
    "healthy",
    "halted",
    "anomalies",
    "training",
    "serving",
)

#: states a row in the ``/requests`` table can report
REQUEST_STATES = ("queued", "prefilling", "decoding")


def _safe(fn: Optional[Callable[[], Any]]) -> Any:
    """Best-effort provider call: the plane reads live state mutated by
    the run's own threads, and a torn read must degrade to null — never
    to a 500 that pages an operator about the observatory itself."""
    if fn is None:
        return None
    try:
        return fn()
    except Exception:
        return None


class OpsPlane:
    """The live HTTP observatory one rank exposes (see module docstring).

    Construction is cheap and binds nothing; :meth:`start` binds the
    socket and launches the daemon serving thread, :meth:`close` shuts
    both down (idempotent).  Attach points mirror the facade's optional
    subsystems — every one of them may stay ``None`` and the affected
    endpoint degrades to null fields or an informative error status.
    """

    def __init__(
        self,
        cfg,
        telemetry=None,
        *,
        registry=None,
        labels: Optional[Dict[str, str]] = None,
        rank: int = 0,
    ):
        self.cfg = cfg
        self.telemetry = telemetry
        self.rank = int(rank)
        self.host = cfg.host
        # multihost contract: rank r binds port + r so colocated ranks
        # never collide; port 0 asks the OS for an ephemeral port (the
        # offset would be meaningless there)
        self.port = cfg.port + self.rank if cfg.port else 0
        self._registry = registry
        self._labels = labels
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None
        # /profile serialization: one capture at a time per plane, on top
        # of the attribution monitor's own in-flight/budget gates
        self._profile_lock = threading.Lock()
        # attach points (all optional)
        self._health = None
        self._tracer = None
        self._attribution = None
        self._engine = None
        self._goodput_fn: Optional[Callable[[], Any]] = None
        self._memory_fn: Optional[Callable[[], Any]] = None
        self._trace_summary_fn: Optional[Callable[[], Any]] = None

    # ----------------------------- attach ------------------------------ #

    def attach_health(self, monitor) -> None:
        """The /healthz flip source (``HealthMonitor.halted``)."""
        self._health = monitor

    def attach_tracer(self, tracer) -> None:
        """The /trace snapshot source (``TraceRecorder``)."""
        self._tracer = tracer

    def attach_attribution(self, monitor) -> None:
        """The /profile capture executor (``AttributionMonitor`` — its
        ``max_captures`` budget bounds scraper-triggered captures)."""
        self._attribution = monitor

    def attach_engine(self, engine) -> None:
        """The /requests table + /statusz serving-block source; a plane
        outliving one engine re-attaches to the next (latest wins)."""
        self._engine = engine

    def attach_training(
        self,
        *,
        goodput: Optional[Callable[[], Any]] = None,
        memory: Optional[Callable[[], Any]] = None,
        trace_summary: Optional[Callable[[], Any]] = None,
    ) -> None:
        """Facade-side summary providers for the /statusz training block
        (each a zero-arg callable returning a JSON-friendly dict or
        None)."""
        self._goodput_fn = goodput
        self._memory_fn = memory
        self._trace_summary_fn = trace_summary

    # ---------------------------- lifecycle ---------------------------- #

    def start(self) -> None:
        """Bind the socket and launch the daemon serving thread.  With
        ``port=0`` the OS assigns an ephemeral port and :attr:`port` is
        updated to the bound one."""
        if self._server is not None:
            return
        from http.server import ThreadingHTTPServer

        handler = _make_handler(self)
        self._server = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._server.server_address[1]
        self._started_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"stoke-opsplane-{self.port}",
            daemon=True,
        )
        self._thread.start()

    @property
    def running(self) -> bool:
        return self._server is not None

    def close(self) -> None:
        """Shut down the server and join the serving thread (idempotent;
        in-flight handlers finish first)."""
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ----------------------------- views ------------------------------- #

    def registry(self):
        """The metrics registry /metrics renders: the explicit override,
        else the run telemetry's, else the attached engine's."""
        if self._registry is not None:
            return self._registry
        if self.telemetry is not None:
            return self.telemetry.registry
        if self._engine is not None:
            return self._engine.metrics.registry
        return None

    def scrape_labels(self) -> Dict[str, str]:
        """The exact labels the run's ``PrometheusSink`` stamps on every
        series — taken FROM the live sink when one exists, so the scrape
        file and /metrics byte-match for the same snapshot; reconstructed
        from the telemetry identity otherwise."""
        if self._labels is not None:
            return dict(self._labels)
        if self.telemetry is not None:
            for sink in getattr(self.telemetry, "sinks", []):
                if isinstance(sink, PrometheusSink):
                    return dict(sink.labels)
            cfg = self.telemetry.config
            if cfg is not None:
                return {
                    "rank": str(self.telemetry.rank),
                    "run": cfg.run_name,
                    **host_labels(self.telemetry.rank),
                }
        return {"rank": str(self.rank), **host_labels(self.rank)}

    def render_metrics(self) -> Optional[str]:
        """The /metrics body: the shared renderer over the live registry
        snapshot with the sink's labels (None when no registry exists)."""
        registry = self.registry()
        if registry is None:
            return None
        return render_prometheus(registry.snapshot(), self.scrape_labels())

    def healthz(self):
        """``(http_status, body)`` for /healthz: 503 once the health
        monitor halted (the load-balancer drain signal), 200 otherwise."""
        halted = getattr(self._health, "halted", None)
        body = {
            "ok": halted is None,
            "halted": halted,
            "anomalies": (
                self._health.anomaly_count
                if self._health is not None
                else None
            ),
        }
        return (503 if halted is not None else 200), body

    def statusz(self) -> Dict[str, Any]:
        """The /statusz object — top-level keys exactly
        :data:`STATUSZ_FIELDS` (pinned; absent subsystems are null)."""
        _, health = self.healthz()
        run = None
        if self.telemetry is not None and self.telemetry.config is not None:
            run = self.telemetry.config.run_name
        training = {
            "goodput": _safe(self._goodput_fn),
            "memory": _safe(self._memory_fn),
            "trace": _safe(self._trace_summary_fn),
        }
        engine = self._engine
        out = {
            "rank": self.rank,
            "host": self.host,
            "port": self.port,
            "run": run,
            "uptime_s": (
                time.monotonic() - self._started_at
                if self._started_at is not None
                else None
            ),
            "healthy": health["ok"],
            "halted": health["halted"],
            "anomalies": health["anomalies"],
            "training": (
                training if any(v is not None for v in training.values())
                else None
            ),
            "serving": _safe(engine.summary) if engine is not None else None,
        }
        assert tuple(out) == STATUSZ_FIELDS  # the wire pin, locally honest
        return out

    def requests_table(self) -> Dict[str, Any]:
        """The /requests body: one row per in-flight request (queued +
        slotted), capped at ``cfg.requests_limit`` rows (``truncated``
        says so).  Rows snapshot live scheduler state mutated by the
        engine thread — each field is read once, best-effort."""
        engine = self._engine
        if engine is None:
            return {"requests": [], "truncated": False}
        now = time.perf_counter()
        rows = []

        def row(req, state: str, blocks: int) -> Dict[str, Any]:
            slo = req.slo
            headroom = None
            if (
                slo is not None
                and slo.ttft_target_s is not None
                and req.first_token_ts is None
            ):
                # the admission signal, per request: seconds left until
                # the TTFT deadline busts (negative: it has)
                headroom = slo.ttft_target_s - (now - req.arrival_ts)
            return {
                "rid": req.rid,
                "priority": slo.priority if slo is not None else None,
                "state": state,
                "tokens_out": len(req.tokens),
                "kv_blocks": blocks,
                "slo_headroom_s": headroom,
                "age_s": now - req.arrival_ts,
            }

        try:
            sched = engine.scheduler
            for req in list(sched.queue):
                rows.append(row(req, "queued", 0))
            for slot in list(sched.slots):
                req = slot.request
                if req is None:
                    continue
                state = (
                    "prefilling" if slot.prefill_pos is not None
                    else "decoding"
                )
                rows.append(row(req, state, len(slot.blocks)))
        except Exception:
            pass  # a torn snapshot degrades to the rows gathered so far
        limit = max(1, int(self.cfg.requests_limit))
        truncated = len(rows) > limit
        return {"requests": rows[:limit], "truncated": truncated}

    def trace_events(self):
        """The /trace body (Chrome trace-event list) or None without a
        tracer."""
        if self._tracer is None:
            return None
        return self._tracer.to_trace_events()

    def profile(self, seconds: Optional[float]):
        """``(http_status, body)`` for /profile: run one bounded manual
        profiler capture through the attribution monitor's budget.  409 when
        a capture is already in flight (auto or scraped), 429 when the
        ``max_captures`` budget is spent, 400 on a bad duration."""
        if self._attribution is None:
            return 404, {
                "ok": False,
                "error": "no attribution monitor attached — on-demand "
                "capture requires an AttributionConfig and a "
                "ProfilerConfig.trace_dir",
            }
        if seconds is None:
            seconds = self.cfg.profile_default_seconds
        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            return 400, {"ok": False, "error": "seconds must be a number"}
        if seconds <= 0:
            return 400, {"ok": False, "error": "seconds must be > 0"}
        # a scraper asking for an hour gets the configured ceiling — the
        # budget bounds HOW MANY captures, the clamp bounds how long each
        # one can pin the profiler
        seconds = min(seconds, self.cfg.profile_max_seconds)
        if not self._profile_lock.acquire(blocking=False):
            return 409, {"ok": False, "error": "capture already in flight"}
        try:
            result = self._attribution.manual_capture(
                seconds, reason="opsplane"
            )
        finally:
            self._profile_lock.release()
        if result.get("ok"):
            return 200, result
        error = result.get("error", "")
        status = (
            429 if "budget" in error else 409 if "in flight" in error
            else 503
        )
        return status, result


def _make_handler(plane: OpsPlane):
    """The per-plane request handler class (BaseHTTPRequestHandler binds
    behavior at the class level, so each plane gets its own subclass
    closing over it)."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        # the plane is an observatory, not an access log generator
        def log_message(self, fmt, *args):  # noqa: D102 - stdlib override
            pass

        def _send(self, status: int, body: str, ctype: str) -> None:
            data = body.encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            try:
                self.wfile.write(data)
            except (BrokenPipeError, ConnectionResetError):
                pass  # scraper hung up mid-write; nothing to salvage

        def _send_json(self, status: int, obj) -> None:
            self._send(
                status, json.dumps(obj, default=str), "application/json"
            )

        def do_GET(self) -> None:  # noqa: N802 - stdlib naming
            parsed = urlparse(self.path)
            route = parsed.path.rstrip("/") or "/"
            try:
                if route == "/metrics":
                    text = plane.render_metrics()
                    if text is None:
                        self._send_json(
                            404, {"error": "no metrics registry attached"}
                        )
                    else:
                        # version=0.0.4 is the text exposition the
                        # renderer targets; Prometheus requires it echoed
                        self._send(
                            200, text,
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                elif route == "/healthz":
                    status, body = plane.healthz()
                    self._send_json(status, body)
                elif route == "/statusz":
                    self._send_json(200, plane.statusz())
                elif route == "/requests":
                    self._send_json(200, plane.requests_table())
                elif route == "/trace":
                    events = plane.trace_events()
                    if events is None:
                        self._send_json(
                            404,
                            {"error": "no trace recorder attached — add a "
                             "TraceConfig"},
                        )
                    else:
                        self._send_json(200, events)
                elif route == "/profile":
                    qs = parse_qs(parsed.query)
                    seconds = qs.get("seconds", [None])[0]
                    status, body = plane.profile(seconds)
                    self._send_json(status, body)
                else:
                    self._send_json(
                        404,
                        {
                            "error": f"unknown endpoint {route!r}",
                            "endpoints": [
                                "/metrics", "/healthz", "/statusz",
                                "/requests", "/trace", "/profile",
                            ],
                        },
                    )
            except Exception as e:  # read-only surface: never crash a run
                self._send_json(500, {"error": repr(e)})

        # a read-only plane: every mutating verb is refused uniformly
        def _refuse(self) -> None:
            self._send_json(
                405, {"error": "the ops plane is read-only (GET only)"}
            )

        do_POST = do_PUT = do_DELETE = do_PATCH = _refuse

    return Handler
