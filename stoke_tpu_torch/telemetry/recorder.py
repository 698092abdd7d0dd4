"""Crash flight recorder: a bounded ring of recent run state and the
post-mortem bundle writer (the port's copy of
``stoke_tpu/telemetry/recorder.py``).

A long run that dies must leave a usable corpse.  The
:class:`FlightRecorder` keeps the last N step events / sentinel rows /
anomaly firings in a host-side ring buffer (no IO on the hot path) and, on
demand — anomaly ``dump`` action, uncaught step-path exception,
SIGTERM/SIGUSR1, or watchdog trip — writes a **post-mortem bundle**
directory containing everything a human (or a supervisor) needs to
triage without re-running:

    <bundle_dir>/postmortem-<utc-ts>-pid<pid>-<reason>/
        manifest.json       reason, wall time, pid, ring length, extra
        ring.jsonl          the ring contents, oldest first
        config.json         the run's StokeStatus.to_dict() (when wired)
        mesh.json           the data axis, world size, device kind
        environment.json    python/torch/numpy versions, CUDA_*/NCCL_*/
                            TORCH_*/STOKE_* env, argv, cwd
        registry.json       latest telemetry-registry snapshot (when wired)
        trace.json          the structured-trace span ring as Perfetto-
                            loadable trace-event JSON (when tracing is on)
        stacks.txt          faulthandler all-thread stacks at dump time

These are the files the JAX package writes for a run with the same
configs; its goodput, cost-card, fleet and numerics files come with the
observatories the port does not run yet.

Bundles are cheap (the ring is small) and atomic enough for crash paths:
files are written directly into a uniquely named directory, so a partial
bundle is visibly partial rather than corrupting a previous one.  When the
``STOKE_HEALTH_BUNDLE_FILE`` env var is set (a supervisor sets it for the
workers it runs), every dump also appends the bundle path there so the
supervisor can attach it to its record.
"""
from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

#: env var a supervisor sets to receive bundle paths (one per line)
BUNDLE_FILE_ENV = "STOKE_HEALTH_BUNDLE_FILE"

#: signals that trigger a dump when ``HealthConfig.dump_signals`` is on
DUMP_SIGNALS = ("SIGTERM", "SIGUSR1")


def _json_safe(value: Any) -> Any:
    """Best-effort conversion to something json.dumps accepts (ring entries
    may carry numpy scalars; a dump must never fail on its payload)."""
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        pass
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if hasattr(value, "item"):  # numpy or torch scalar
        try:
            return value.item()
        except Exception:
            pass
    return repr(value)


class FlightRecorder:
    """Bounded ring buffer + post-mortem bundle writer.

    Thread-safe: the watchdog thread and signal handlers dump concurrently
    with the training thread recording.  Ring recording is append-only into
    a ``deque(maxlen=ring_size)`` — O(1), no IO, no device touches.
    """

    def __init__(
        self,
        bundle_dir: str,
        ring_size: int = 256,
        *,
        status_dict: Optional[Dict[str, Any]] = None,
        mesh_info: Optional[Dict[str, Any]] = None,
        snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        install_signal_handlers: bool = False,
        trace_fn: Optional[Callable[[], Any]] = None,
    ):
        self.bundle_dir = bundle_dir
        self._ring: "deque[dict]" = deque(maxlen=int(ring_size))
        # RLock, not Lock: the SIGTERM/SIGUSR1 dump handler runs ON the
        # main thread and may interrupt a frame that already holds this
        # lock (record() runs every step) — a plain Lock would deadlock
        # the process exactly on the crash path this module exists for
        self._lock = threading.RLock()
        self._status_dict = status_dict
        self._mesh_info = mesh_info
        self._snapshot_fn = snapshot_fn
        # what the host was doing at time of death: the span ring as
        # Perfetto-loadable trace.json joins every bundle
        self._trace_fn = trace_fn
        self.dumps: List[str] = []
        self._prev_handlers: Dict[int, Any] = {}
        if install_signal_handlers:
            self._install_signal_handlers()

    # ------------------------------------------------------------------ #
    # ring
    # ------------------------------------------------------------------ #

    def record(self, kind: str, payload: Dict[str, Any]) -> None:
        """Append one entry to the ring (``kind`` tags the entry type:
        ``step_event`` / ``sentinels`` / ``anomaly`` / ``note``)."""
        entry = {"ts": time.time(), "kind": kind, **payload}
        with self._lock:
            self._ring.append(entry)

    def record_event(self, record: Dict[str, Any]) -> None:
        """Append a telemetry step event (the JSONL record verbatim)."""
        self.record("step_event", {"event": record})

    @property
    def ring(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------------ #
    # bundle dump
    # ------------------------------------------------------------------ #

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None) -> str:
        """Write a post-mortem bundle; returns the bundle directory path.

        Never raises: the dump runs on crash paths (signal handlers,
        watchdog thread, exception unwinding) where a secondary failure
        would mask the primary one — IO errors degrade to a partial bundle
        and a stderr note.
        """
        ts = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        safe_reason = "".join(
            c if (c.isalnum() or c in "-_") else "-" for c in reason
        )[:64]
        # pid in the name: multi-host runs may share bundle_dir on one
        # filesystem, and same-process concurrent dumpers (watchdog
        # thread, signal handler, exception unwind) are serialized by the
        # atomic exist_ok=False create below — a check-then-create would
        # let two same-second dumps overwrite each other's corpse
        base = os.path.join(
            self.bundle_dir,
            f"postmortem-{ts}-pid{os.getpid()}-{safe_reason}",
        )
        path = base
        suffix = 0
        while True:
            try:
                os.makedirs(path, exist_ok=False)
                break
            except FileExistsError:
                suffix += 1
                path = f"{base}.{suffix}"
            except OSError as e:
                sys.stderr.write(
                    f"Stoke -- flight recorder could not create bundle dir "
                    f"{path!r}: {e}\n"
                )
                return path
        ring = self.ring
        self._write_json(path, "manifest.json", {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "ring_entries": len(ring),
            **({"extra": _json_safe(extra)} if extra else {}),
        })
        self._write_jsonl(path, "ring.jsonl", ring)
        if self._status_dict is not None:
            self._write_json(path, "config.json", self._status_dict)
        if self._mesh_info is not None:
            self._write_json(path, "mesh.json", self._mesh_info)
        self._write_json(path, "environment.json", self._environment())
        if self._snapshot_fn is not None:
            try:
                self._write_json(path, "registry.json", self._snapshot_fn())
            except Exception:
                pass
        if self._trace_fn is not None:
            try:
                events = self._trace_fn()
                if events:
                    self._write_json(
                        path, "trace.json", {"traceEvents": events}
                    )
            except Exception:
                pass
        self._write_stacks(path)
        with self._lock:
            self.dumps.append(path)
        self._notify_supervisor(path)
        sys.stderr.write(
            f"Stoke -- health post-mortem bundle written: {path} "
            f"(reason: {reason})\n"
        )
        return path

    def _write_json(self, bundle: str, name: str, payload: Any) -> None:
        try:
            with open(os.path.join(bundle, name), "w") as f:
                json.dump(_json_safe(payload), f, indent=2, default=repr)
                f.write("\n")
        except OSError:
            pass

    def _write_jsonl(self, bundle: str, name: str, entries: List[dict]) -> None:
        try:
            with open(os.path.join(bundle, name), "w") as f:
                for entry in entries:
                    f.write(json.dumps(_json_safe(entry), default=repr))
                    f.write("\n")
        except OSError:
            pass

    def _write_stacks(self, bundle: str) -> None:
        """All-thread python stacks via faulthandler — the "where was
        everyone when it died" file, and the watchdog's main payload."""
        try:
            with open(os.path.join(bundle, "stacks.txt"), "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
        except (OSError, RuntimeError):
            pass

    @staticmethod
    def _environment() -> Dict[str, Any]:
        versions: Dict[str, Any] = {"python": sys.version}
        try:
            import torch

            versions["cuda"] = torch.version.cuda
        except Exception:
            pass
        for mod in ("torch", "numpy"):
            try:
                versions[mod] = __import__(mod).__version__
            except Exception:
                pass
        env = {
            k: v for k, v in os.environ.items()
            if k.startswith(("CUDA_", "NCCL_", "TORCH_", "STOKE_"))
        }
        return {
            "versions": versions,
            "env": env,
            "argv": list(sys.argv),
            "cwd": os.getcwd(),
        }

    @staticmethod
    def _notify_supervisor(bundle_path: str) -> None:
        target = os.environ.get(BUNDLE_FILE_ENV)
        if not target:
            return
        try:
            with open(target, "a") as f:
                f.write(bundle_path + "\n")
        except OSError:
            pass

    # ------------------------------------------------------------------ #
    # signals
    # ------------------------------------------------------------------ #

    def _install_signal_handlers(self) -> None:
        """Dump a bundle on SIGTERM/SIGUSR1, then chain to the previous
        handler (so SIGTERM still terminates).  Signal handlers can only be
        installed from the main thread; elsewhere (e.g. a test worker) this
        silently skips — the other dump triggers still work."""
        for name in DUMP_SIGNALS:
            signum = getattr(signal, name, None)
            if signum is None:
                continue
            try:
                prev = signal.signal(signum, self._on_signal)
            except (ValueError, OSError):  # non-main thread / unsupported
                return
            self._prev_handlers[signum] = prev

    def _on_signal(self, signum, frame) -> None:
        self.dump(f"signal-{signal.Signals(signum).name}")
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL and signum == signal.SIGTERM:
            # default SIGTERM disposition is termination; honor it
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def uninstall_signal_handlers(self) -> None:
        """Restore the previous handlers (test hygiene / facade close)."""
        for signum, prev in self._prev_handlers.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
