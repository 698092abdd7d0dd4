"""The restart supervisor: runs a training command under a bounded restart
loop.

    python -m stoke_tpu_torch.supervise [--max-restarts 8] \
        [--extra-resumable N ...] [--record restarts.jsonl] -- python train.py

Counterpart of ``scripts/run_resilient.py`` (``run_resilient``, ``:127``)
and ``scripts/_supervise.py`` (``supervise``, ``:62``: the worker under
idle and absolute watchdogs, with the health bundle handshake):

- **Classification**: the worker's exit code decides the next move
  (:func:`stoke_tpu_torch.resilience.classify_exit`). ``0`` is done; the
  health watchdog's 113, the preemption drain's 114, signal deaths
  (SIGKILL, SIGTERM) and ``--extra-resumable`` codes restart after a
  backoff; anything else (a Python crash) is fatal.
- **Backoff**: exponential with jitter and a restart budget
  (:class:`~stoke_tpu_torch.resilience.RestartBackoff`).
- **Records**: one JSONL line an attempt (exit code, class, its seconds,
  the backoff, the flight recorder's bundle paths through the
  ``STOKE_HEALTH_BUNDLE_FILE`` handshake and, when a preemption bundle
  carries them, the dying worker's step time and lost steps priced as
  lost goodput seconds).
- **Attempt number**: each attempt runs with ``STOKE_RESTART_ATTEMPT=<n>``
  (the worker's ``resilience/restarts`` gauge).
- **Watchdogs** (``--idle-s``, ``--watchdog-s``): a worker that printed
  nothing for ``idle_s`` seconds, or ran past ``watchdog_s``, is killed;
  the attempt counts as a signal death (resumable).

The worker is expected to call ``Stoke.resume()`` at start, so a restart
continues from the emergency (or newest periodic) checkpoint.

This module imports neither ``torch`` nor the package's torch modules
(the package root loads its names lazily): a worker that wedged its CUDA
context cannot take the supervisor with it.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import selectors
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

from stoke_tpu_torch.resilience import (
    PREEMPTION_EXIT_CODE,
    RESTART_ATTEMPT_ENV,
    RestartBackoff,
    _WATCHDOG_EXIT_CODE,
    classify_exit,
)

#: the variable the flight recorder appends bundle paths to
#: (``telemetry.recorder.BUNDLE_FILE_ENV``)
BUNDLE_FILE_ENV = "STOKE_HEALTH_BUNDLE_FILE"


def _read_bundles(path: str) -> list:
    """Bundle paths the worker's flight recorder reported (empty when no
    bundle was written or the handshake file is unreadable)."""
    try:
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]
    except OSError:
        return []


def _lost_goodput_estimate(bundles: Sequence[str]) -> Optional[dict]:
    """The restart's cost from the NEWEST bundle carrying the preemption
    dump's accounting: ``step_ema_s`` (host seconds of one optimizer
    step) times ``lost_steps_estimate`` (0 when the emergency save landed,
    the steps since the last durable save when it failed). None when no
    bundle carries them."""
    for bundle in reversed(list(bundles)):
        try:
            with open(os.path.join(bundle, "manifest.json")) as f:
                extra = (json.load(f) or {}).get("extra") or {}
        except (OSError, ValueError):
            continue
        lost = extra.get("lost_steps_estimate")
        ema = extra.get("step_ema_s")
        if lost is None:
            continue
        out = {"lost_steps_estimate": int(lost)}
        if ema is not None:
            out["step_ema_s"] = round(float(ema), 6)
            out["lost_goodput_s_est"] = round(int(lost) * float(ema), 3)
        return out
    return None


def supervise(argv: Sequence[str], env: Dict[str, str],
              watchdog_s: Optional[float] = None,
              idle_s: Optional[float] = None) -> int:
    """Run one worker attempt, relaying its standard output, under an
    idle watchdog (no output for ``idle_s`` seconds) and an absolute one
    (``watchdog_s``); a worker they kill reports ``-SIGKILL``. The
    worker's 113 (its hang watchdog) and 114 (a clean preemption drain)
    are named on the supervisor's standard error."""
    if watchdog_s is None and idle_s is None:
        code = subprocess.Popen(list(argv), env=env).wait()
    else:
        code = _watched(argv, env, watchdog_s, idle_s)
    if code == _WATCHDOG_EXIT_CODE:
        sys.stderr.write(
            f"supervise: worker killed by its health watchdog (exit "
            f"{_WATCHDOG_EXIT_CODE}: no step completed within its "
            f"timeout)\n")
    elif code == PREEMPTION_EXIT_CODE:
        sys.stderr.write(
            f"supervise: worker preempted and drained cleanly (exit "
            f"{PREEMPTION_EXIT_CODE}: emergency checkpoint written; "
            f"resumable via Stoke.resume())\n")
    return code


def _watched(argv, env, watchdog_s, idle_s) -> int:
    proc = subprocess.Popen(list(argv), env=env, stdout=subprocess.PIPE)
    fd = proc.stdout.fileno()
    os.set_blocking(fd, False)
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    start = last = time.monotonic()
    why = None
    try:
        while proc.poll() is None:
            if sel.select(timeout=1.0):
                try:
                    chunk = os.read(fd, 65536)
                except BlockingIOError:
                    chunk = None
                if chunk:
                    sys.stdout.buffer.write(chunk)
                    sys.stdout.flush()
                    last = time.monotonic()
                elif chunk == b"":
                    sel.unregister(proc.stdout)
                    time.sleep(1.0)
            now = time.monotonic()
            if watchdog_s is not None and now - start > watchdog_s:
                why = f"ran past {watchdog_s}s (absolute watchdog)"
                break
            if idle_s is not None and now - last > idle_s:
                why = f"printed nothing for {idle_s}s (idle watchdog)"
                break
    finally:
        sel.close()
    if why is None:
        try:
            rest = proc.stdout.read() or b""
        except OSError:
            rest = b""
        sys.stdout.buffer.write(rest)
        sys.stdout.flush()
        return proc.returncode
    sys.stderr.write(f"supervise: killing the worker: it {why}\n")
    proc.kill()
    proc.wait()
    return -signal.SIGKILL


def run_resilient(
    argv: Sequence[str],
    *,
    max_restarts: int = 8,
    base_s: float = 1.0,
    factor: float = 2.0,
    max_s: float = 60.0,
    jitter_frac: float = 0.5,
    extra_resumable: Sequence[int] = (),
    record_path: Optional[str] = None,
    seed: Optional[int] = None,
    env: Optional[Dict[str, str]] = None,
    run: Callable[[Sequence[str], Dict[str, str]], int] = supervise,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> Dict[str, Any]:
    """Drive ``argv`` under the bounded restart loop; returns a summary
    (``ok`` / ``fatal`` / ``exhausted``, ``attempts``, ``restarts``,
    ``elapsed_s`` over all attempts, ``lost_goodput_s_est`` summed over
    the attempts whose bundles priced it, and the per-attempt
    ``records``). ``run``, ``sleep`` and ``clock`` are injectable so the
    schedule tests run deterministic and instantaneous; ``seed`` pins the
    jitter."""
    backoff = RestartBackoff(
        base_s=base_s, factor=factor, max_s=max_s, jitter_frac=jitter_frac,
        max_restarts=max_restarts,
        rng=random.Random(seed) if seed is not None else None)
    records = []
    attempt = 0
    outcome: Dict[str, Any] = {"ok": False}
    t_start = clock()
    while True:
        bundle_fd, bundle_file = tempfile.mkstemp(prefix="stoke-bundles-")
        os.close(bundle_fd)
        attempt_env = {
            **(env if env is not None else os.environ),
            RESTART_ATTEMPT_ENV: str(attempt),
            BUNDLE_FILE_ENV: bundle_file,
        }
        t0 = clock()
        code = run(argv, attempt_env)
        elapsed_s = clock() - t0
        bundles = _read_bundles(bundle_file)
        try:
            os.remove(bundle_file)
        except OSError:
            pass
        classification = classify_exit(code, extra_resumable)
        record = {
            "attempt": attempt,
            "exit_code": code,
            "class": classification,
            "elapsed_s": round(elapsed_s, 3),
            "bundles": bundles,
            "restarts_used": backoff.restarts_used,
        }
        cost = _lost_goodput_estimate(bundles)
        if cost is not None:
            record.update(cost)
        if classification == "ok":
            outcome = {"ok": True}
        elif classification == "fatal":
            outcome = {"ok": False, "fatal": True, "exit_code": code}
        else:
            delay = backoff.next_delay()
            if delay is None:
                outcome = {"ok": False, "exhausted": True, "exit_code": code,
                           "max_restarts": max_restarts}
            else:
                record["backoff_s"] = round(delay, 3)
        records.append(record)
        if record_path:
            with open(record_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        sys.stderr.write(
            f"supervise: attempt {attempt} exited {code} ({classification})"
            + (f"; restarting in {record['backoff_s']}s"
               if "backoff_s" in record else "") + "\n")
        if "backoff_s" not in record:
            break
        sleep(record["backoff_s"])
        attempt += 1
    outcome["attempts"] = attempt + 1
    outcome["restarts"] = attempt
    outcome["elapsed_s"] = round(clock() - t_start, 3)
    priced = [r["lost_goodput_s_est"] for r in records
              if "lost_goodput_s_est" in r]
    outcome["lost_goodput_s_est"] = round(sum(priced), 3) if priced else None
    outcome["records"] = records
    return outcome


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m stoke_tpu_torch.supervise",
        description="bounded restart supervisor: restarts resumable worker "
        "deaths (preemption 114, watchdog 113, signal kills) with "
        "exponential backoff; fatal exits stop at once")
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--base-s", type=float, default=1.0,
                    help="first backoff delay (doubles per restart)")
    ap.add_argument("--max-s", type=float, default=60.0,
                    help="backoff ceiling")
    ap.add_argument("--jitter-frac", type=float, default=0.5,
                    help="additive-uniform jitter as a fraction of the "
                    "delay (de-synchronizes fleet restarts)")
    ap.add_argument("--extra-resumable", type=int, nargs="*", default=[],
                    help="additional exit codes to classify as resumable")
    ap.add_argument("--record", default=None,
                    help="append one JSONL restart record per attempt here")
    ap.add_argument("--seed", type=int, default=None,
                    help="pin the jitter rng")
    ap.add_argument("--idle-s", type=float, default=None,
                    help="kill an attempt that printed nothing this long")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="kill an attempt that runs longer than this")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no worker command given (append: -- python train.py ...)")
    outcome = run_resilient(
        cmd, max_restarts=args.max_restarts, base_s=args.base_s,
        max_s=args.max_s, jitter_frac=args.jitter_frac,
        extra_resumable=args.extra_resumable, record_path=args.record,
        seed=args.seed,
        run=lambda a, e: supervise(a, e, args.watchdog_s, args.idle_s))
    summary = {k: v for k, v in outcome.items() if k != "records"}
    print(json.dumps({"supervise": summary}), flush=True)
    if outcome.get("ok"):
        return 0
    # the worker's own fatal code where there is one; a signal death as
    # the shell's 128+signum
    code = int(outcome.get("exit_code") or 1)
    return 128 - code if code < 0 else code


if __name__ == "__main__":
    sys.exit(main())
