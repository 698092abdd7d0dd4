"""Telemetry sinks: JSONL step events, Prometheus text exposition, and the
native TensorBoard event writer (the port's copy of
``stoke_tpu/telemetry/sinks.py``; ``render_prometheus`` gives the same text
as the JAX package's for the same snapshot).

Every sink implements the same two-method contract:

- ``emit(record, snapshot)`` — called at the logging cadence with the
  structured step event (``events.py`` schema) and the registry snapshot.
- ``close()`` — flush + release file handles (idempotent).

Sinks never raise into the training loop: IO errors are warned once and the
sink disables itself (a full disk must not kill a 3-day run at step 40k).
"""

from __future__ import annotations

import json
import math
import os
import warnings
from typing import Dict, Optional

from stoke_tpu_torch.telemetry.events import validate_step_event


class Sink:
    """Base: subclasses override ``_emit``; failure handling is shared."""

    def __init__(self):
        self._dead = False
        self._warned_invalid = False

    def emit(self, record: dict, snapshot: Dict[str, dict]) -> None:
        if self._dead:
            return
        try:
            self._emit(record, snapshot)
        except OSError as e:  # disk full / perms / unmounted — disable, warn
            self._dead = True
            warnings.warn(
                f"Stoke -- telemetry sink {type(self).__name__} disabled "
                f"after IO error: {e}"
            )
        except ValueError as e:
            # a record failing schema validation (validate_step_event names
            # the offending key in its message) must not raise into the
            # training loop: drop the record, warn ONCE, and keep the sink
            # alive — later valid records still flow
            if not self._warned_invalid:
                self._warned_invalid = True
                warnings.warn(
                    f"Stoke -- telemetry sink {type(self).__name__} dropped "
                    f"an invalid step event (further drops are silent): {e}"
                )

    def _emit(self, record: dict, snapshot: Dict[str, dict]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


# --------------------------------------------------------------------------- #
# JSONL structured step events
# --------------------------------------------------------------------------- #


class JsonlSink(Sink):
    """One schema-validated JSON line per step window, append-only.

    Multi-host: rank 0 writes by default; ``TelemetryConfig.
    jsonl_all_ranks`` gives every process its own ``steps.rank<N>.jsonl``
    (records carry the rank, so files concatenate cleanly)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)  # line-buffered: crash-safe

    def _emit(self, record: dict, snapshot: Dict[str, dict]) -> None:
        validate_step_event(record)
        self._f.write(json.dumps(record, sort_keys=True) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# --------------------------------------------------------------------------- #
# Prometheus text exposition (scrape file)
# --------------------------------------------------------------------------- #


def host_labels(process_index: int = 0) -> Dict[str, str]:
    """Identity labels for multi-host expositions:
    ``host`` (this machine's hostname) and ``process_index`` (the
    process's rank).  Without them, per-host scrape files of the same job
    aggregated into one Prometheus collide into a single series and the
    per-host skew the fleet view exists to expose is unplottable."""
    import socket

    try:
        host = socket.gethostname() or "unknown"
    except OSError:  # pragma: no cover - exotic resolver failures
        host = "unknown"
    return {"host": host, "process_index": str(int(process_index))}


def _prom_name(name: str) -> str:
    """Registry name -> Prometheus metric name: slashes become underscores,
    invalid chars collapse, and everything gets the ``stoke_`` namespace."""
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch in "_:") else "_")
    sanitized = "".join(out).strip("_")
    if sanitized and sanitized[0].isdigit():
        sanitized = "_" + sanitized
    return f"stoke_{sanitized}"


def _prom_value(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def render_prometheus(snapshot: Dict[str, dict], labels: Optional[Dict[str, str]] = None) -> str:
    """Registry snapshot -> Prometheus text exposition format 0.0.4
    (HELP/TYPE headers, ``_total`` counters, cumulative ``_bucket`` series).
    Pure function — unit-tested against the format grammar."""
    label_str = ""
    if labels:

        def esc(v):
            # exposition-format label escaping: backslash FIRST (or the
            # escapes it introduces get re-escaped), then quote, then
            # newline — a raw newline in a label value truncates the
            # sample line and poisons every scrape of the file
            return (
                str(v)
                .replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
            )

        inner = ",".join(f'{k}="{esc(v)}"' for k, v in sorted(labels.items()))
        label_str = "{" + inner + "}"
    lines = []
    for name in sorted(snapshot):
        meta = snapshot[name]
        pname = _prom_name(name)
        kind = meta["kind"]
        # the _total suffix is part of the exposed family name: HELP/TYPE
        # and the sample line must all use it or strict OpenMetrics parsers
        # see an orphan HELP family
        if kind == "counter" and not pname.endswith("_total"):
            pname += "_total"
        if meta.get("help"):
            lines.append(f"# HELP {pname} {meta['help']}")
        if kind == "counter":
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname}{label_str} {_prom_value(meta['value'])}")
        elif kind == "gauge":
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname}{label_str} {_prom_value(meta['value'])}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            for le, cum in meta["buckets"]:
                le_s = "+Inf" if math.isinf(le) else _prom_value(le)
                if labels:
                    bucket_labels = label_str[:-1] + f',le="{le_s}"}}'
                else:
                    bucket_labels = f'{{le="{le_s}"}}'
                lines.append(f"{pname}_bucket{bucket_labels} {cum}")
            lines.append(f"{pname}_sum{label_str} {_prom_value(meta['sum'])}")
            lines.append(f"{pname}_count{label_str} {meta['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


class PrometheusSink(Sink):
    """Atomic-rename text-exposition file for node-exporter-style scraping
    (``textfile`` collector / sidecar cat).  Rewritten whole at each cadence
    — scrapers never observe a half-written file."""

    def __init__(self, path: str, labels: Optional[Dict[str, str]] = None):
        super().__init__()
        self.path = path
        self.labels = dict(labels or {})
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _emit(self, record: dict, snapshot: Dict[str, dict]) -> None:
        text = render_prometheus(snapshot, self.labels)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, self.path)


# --------------------------------------------------------------------------- #
# TensorBoard (native event writer, utils/tb_writer.py)
# --------------------------------------------------------------------------- #

#: step-event fields mirrored to TB as scalars (null fields skipped)
_TB_RECORD_FIELDS = (
    "host_dispatch_s", "device_step_s", "loader_wait_s", "samples_per_s",
    "tokens_per_s", "ema_loss", "step_loss", "grad_norm", "skipped_steps",
    "recompiles", "compile_time_s", "hbm_bytes_in_use", "hbm_peak_bytes",
)


class TensorBoardSink(Sink):
    """Scalar mirror of the step events into the native TB event writer
    (``utils/tb_writer.py`` — the JAX package's file format, which the
    frame parser in tests/test_utils.py pins), tags under ``telemetry/``."""

    def __init__(self, logdir: Optional[str] = None, writer=None):
        super().__init__()
        if writer is None:
            from stoke_tpu_torch.utils.tb_writer import TBEventWriter

            writer = TBEventWriter(logdir)
        self.writer = writer

    def _emit(self, record: dict, snapshot: Dict[str, dict]) -> None:
        step = record["step"]
        for field in _TB_RECORD_FIELDS:
            v = record.get(field)
            if v is None:
                continue
            self.writer.add_scalar(f"telemetry/{field}", float(v), step)
        ls = record.get("loss_scale")
        if isinstance(ls, list):
            for i, v in enumerate(ls):
                self.writer.add_scalar(f"telemetry/loss_scale_{i}", float(v), step)
        elif ls is not None:
            self.writer.add_scalar("telemetry/loss_scale", float(ls), step)
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()
