"""Preemption-safe saves, verified resume and fault injection: the host
side of resilience, imported by the facade, the checkpoint writer and the
restart supervisor.

The port's own copy of ``stoke_tpu/resilience.py`` (the port imports
nothing of the JAX package): the same constants, exit-code classes,
backoff schedule, manifest format, tag discovery, chaos grammar and
messages, and the same ``ResilienceMonitor``.

1. **Preemption-aware save**: :class:`ResilienceMonitor` installs handlers
   for the preemption signals (SIGTERM by default). A handler only sets a
   flag; the facade reads it at every optimizer-step boundary, where the
   step is complete, drains the async saves (``io_ops.wait_for_saves``),
   writes an **emergency checkpoint** whose extras carry the generator
   state, the loss EMA, the skipped steps and the error-feedback residual,
   and then exits with :data:`PREEMPTION_EXIT_CODE` (or raises
   :class:`PreemptedError` with ``exit_on_preempt=False``).
2. **Verified resume**: every checkpoint written under a
   ``ResilienceConfig`` carries a ``manifest.json`` of sha256 digests.
   :func:`find_latest_valid_checkpoint` walks tags newest first, verifies
   each, **quarantines** (renames, never deletes) a corrupt or partial one
   and returns the newest valid tag.
3. **Supervised restarts**: :class:`RestartBackoff` and
   :func:`classify_exit` are what :mod:`stoke_tpu_torch.supervise` builds
   its bounded restart loop from.
4. **Fault injection**: ``STOKE_CHAOS`` (or ``ResilienceConfig.chaos``):
   ``kill_at_step=K`` (SIGTERM, SIGKILL or an exception),
   ``corrupt_save=N``, ``wedge_at_step=K,wedge_s=S`` and
   ``kill_during_save=N``.

This module imports neither ``torch`` nor anything of the package at
module scope, so the supervisor, which imports it, never initialises
CUDA: a child that wedged its CUDA context cannot take the supervisor
with it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import signal
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: exit code of a preempted worker that drained and saved cleanly — kept
#: distinct from the health watchdog's 113 ("hung and self-terminated") so
#: supervisors can tell a graceful drain from a wedge
PREEMPTION_EXIT_CODE = 114

#: the health hang-watchdog's exit code (``telemetry.health
#: .WATCHDOG_EXIT_CODE``, kept here so this module stays import-light)
_WATCHDOG_EXIT_CODE = 113

#: exit codes a supervisor restarts by default: watchdog kill (the run hung
#: on a wedged collective — a fresh process usually un-wedges it) and the
#: graceful preemption drain above
RESUMABLE_EXIT_CODES: Tuple[int, ...] = (
    _WATCHDOG_EXIT_CODE,
    PREEMPTION_EXIT_CODE,
)

#: env var the supervisor sets so a restarted worker knows its attempt
#: number (surfaces as the ``resilience/restarts`` gauge / JSONL column)
RESTART_ATTEMPT_ENV = "STOKE_RESTART_ATTEMPT"

#: env var carrying the chaos spec (``ResilienceConfig.chaos`` overrides)
CHAOS_ENV = "STOKE_CHAOS"

#: manifest file name inside a checkpoint tag directory
MANIFEST_NAME = "manifest.json"

#: quarantine subdirectory created next to the tags it quarantines
QUARANTINE_DIRNAME = "quarantine"


class PreemptedError(BaseException):
    """Raised at an optimizer-step boundary after the emergency checkpoint
    was written, when ``ResilienceConfig.exit_on_preempt=False`` (in-process
    tests and smoke runs that resume without a process restart).

    Subclasses ``BaseException`` — like ``SystemExit``, it means "this
    process is leaving", and must not be swallowed by ``except Exception``
    error handling (or dumped as a crash by the health monitor's
    exception-path recorder)."""

    def __init__(self, step: int, tag_dir: Optional[str], exit_code: int):
        self.step = int(step)
        self.tag_dir = tag_dir
        self.exit_code = int(exit_code)
        super().__init__(
            f"Stoke -- preempted at optimizer step {step}; emergency "
            f"checkpoint: {tag_dir or '<save failed>'} "
            f"(resumable exit code {exit_code})"
        )


class ChaosError(RuntimeError):
    """Raised by the ``kill_at_step`` injector in ``mode=exception`` — a
    deterministic stand-in for an uncaught training-loop crash."""


# --------------------------------------------------------------------------- #
# exit-code classification (the supervisor's restart decision)
# --------------------------------------------------------------------------- #


def classify_exit(
    code: int, extra_resumable: Sequence[int] = ()
) -> str:
    """``"ok"`` / ``"resumable"`` / ``"fatal"`` for one worker exit code.

    Resumable: the distinct self-reported codes (watchdog 113, preemption
    114, plus ``extra_resumable``) and signal deaths — negative returncodes
    from ``subprocess`` or the shell convention ``128+signum`` reported by
    wrapper launchers (SIGKILL/SIGTERM are how preempted VMs and OOM
    killers end a process).  Everything else — including a generic python
    crash (exit 1, e.g. a status-validation error) — is fatal: restarting a
    deterministic bug burns the restart budget without ever progressing.
    """
    if code == 0:
        return "ok"
    if code in RESUMABLE_EXIT_CODES or code in tuple(extra_resumable):
        return "resumable"
    if code < 0:  # killed by a signal (host-level disruption)
        return "resumable"
    if 128 < code <= 128 + 64:
        # shell convention for signal deaths (128+signum): what a wrapper
        # launcher — including the supervisor's own main() — reports when
        # the real worker died to SIGKILL/SIGTERM.  Same verdict as the
        # raw negative returncode above.
        return "resumable"
    return "fatal"


# --------------------------------------------------------------------------- #
# restart backoff (exponential + jitter + budget; no sleeping in here)
# --------------------------------------------------------------------------- #


class RestartBackoff:
    """Bounded exponential backoff with jitter for the restart loop.

    Pure scheduling arithmetic: :meth:`next_delay` returns how long the
    caller should sleep before the next restart, or ``None`` once the
    restart budget is exhausted.  It never sleeps itself and takes an
    injectable ``rng`` (``random.Random``), so tests run it deterministic
    and instantaneous.
    """

    def __init__(
        self,
        base_s: float = 1.0,
        factor: float = 2.0,
        max_s: float = 60.0,
        jitter_frac: float = 0.5,
        max_restarts: int = 8,
        rng: Optional[random.Random] = None,
    ):
        if base_s < 0 or factor < 1 or max_s < 0 or jitter_frac < 0:
            raise ValueError(
                "RestartBackoff needs base_s/max_s/jitter_frac >= 0 and "
                "factor >= 1"
            )
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)
        self.jitter_frac = float(jitter_frac)
        self.max_restarts = int(max_restarts)
        self.restarts_used = 0
        self._rng = rng if rng is not None else random.Random()

    @property
    def exhausted(self) -> bool:
        return self.restarts_used >= self.max_restarts

    def next_delay(self) -> Optional[float]:
        """Delay (seconds) before the next restart, or None when the budget
        is spent.  Jitter is additive-uniform in ``[0, jitter_frac * delay]``
        — a fleet of preempted workers must not restart in lockstep."""
        if self.exhausted:
            return None
        n = self.restarts_used
        self.restarts_used += 1
        delay = min(self.max_s, self.base_s * (self.factor ** n))
        return delay + delay * self.jitter_frac * self._rng.random()


# --------------------------------------------------------------------------- #
# checkpoint manifests: per-file integrity digests
# --------------------------------------------------------------------------- #


def _file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _walk_files(tag_dir: str) -> List[str]:
    """Relative paths of every regular file under ``tag_dir`` (sorted; the
    manifest itself excluded).  ``*.tmp`` names are excluded too: every
    writer in this repo lands files atomically via tmp+``os.replace``, so
    a ``.tmp`` is by definition an in-flight write — digesting one (e.g.
    another rank's file mid-write) would bake a
    transient name into the manifest and permanently fail verification of
    a healthy checkpoint once the rename retires it."""
    out = []
    for root, _dirs, files in os.walk(tag_dir):
        for name in files:
            if name.endswith(".tmp"):
                continue
            rel = os.path.relpath(os.path.join(root, name), tag_dir)
            if rel != MANIFEST_NAME:
                out.append(rel)
    return sorted(out)


def write_manifest(tag_dir: str, extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``manifest.json`` into a completed checkpoint tag: per-file
    sha256 + byte counts over every file currently in the tag.  Written
    LAST (after ``meta.json``), so a tag with a manifest is a tag whose
    write finished — resume-side validation treats digest mismatch AND
    missing listed files as corruption.  Returns the manifest path.

    Digesting re-reads the tag from disk (roughly doubling the save's
    read IO) — a deliberate trade-off even on the emergency path: the
    digest over the bytes that LANDED is what the quarantine guarantee
    rests on, and a grace-window kill mid-hash just leaves a manifest-less
    tag that resume treats as the partial write it is."""
    files = {}
    for rel in _walk_files(tag_dir):
        full = os.path.join(tag_dir, rel)
        files[rel] = {
            "sha256": _file_sha256(full),
            "bytes": os.path.getsize(full),
        }
    manifest = {
        "version": 1,
        "written_ts": time.time(),
        "files": files,
        **(extra or {}),
    }
    path = os.path.join(tag_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)  # atomic: a torn manifest must not look valid
    return path


def verify_checkpoint(
    tag_dir: str, require_manifest: bool = False
) -> Tuple[bool, str]:
    """``(ok, reason)`` for one checkpoint tag directory.

    Validation ladder:
      1. ``meta.json`` must exist and parse (async saves write it last — a
         meta-less tag is a partial write by construction).
      2. A staged (offload) layout must be COMPLETE: meta records how many
         processes wrote shard files for which state keys —
         every process's writer runs independently, so a hard kill can
         strand meta.json ahead of a lagging rank's payload; the missing
         rank file is the half-staged signature this check catches.
      3. With a manifest: every listed file must exist with a matching
         sha256 digest (bit rot, truncation, chaos-injected corruption).
      4. Without a manifest: valid iff ``require_manifest`` is False
         (pre-resilience checkpoints stay loadable).
    """
    meta_path = os.path.join(tag_dir, "meta.json")
    if not os.path.isdir(tag_dir):
        return False, "not a directory"
    if not os.path.exists(meta_path):
        return False, "missing meta.json (partial write)"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable meta.json ({e})"
    staged = meta.get("staged") if isinstance(meta, dict) else None
    if staged:
        try:
            processes = int(staged["processes"])
            keys = list(staged["keys"])
        except (KeyError, TypeError, ValueError):
            return False, "malformed staged marker in meta.json"
        for key in keys:
            for r in range(max(processes, 1)):
                for suffix in ("npz", "json"):
                    rel = f"{key}.staged.rank{r}.{suffix}"
                    if not os.path.exists(os.path.join(tag_dir, rel)):
                        return False, (
                            f"staged payload incomplete: missing {rel}"
                        )
    manifest_path = os.path.join(tag_dir, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        if require_manifest:
            return False, "missing manifest.json"
        return True, "ok (no manifest)"
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        listed = manifest["files"]
    except (OSError, ValueError, KeyError) as e:
        return False, f"unreadable manifest.json ({e})"
    for rel, entry in listed.items():
        full = os.path.join(tag_dir, rel)
        if not os.path.exists(full):
            return False, f"missing file {rel}"
        try:
            if os.path.getsize(full) != entry.get("bytes"):
                return False, f"size mismatch in {rel}"
            if _file_sha256(full) != entry.get("sha256"):
                return False, f"digest mismatch in {rel}"
        except OSError as e:
            return False, f"unreadable file {rel} ({e})"
    return True, "ok"


def read_manifest(tag_dir: str) -> Optional[Dict[str, Any]]:
    """The parsed ``manifest.json`` of a checkpoint tag, or None when the
    tag carries none / it is unreadable.  The manifest is where the
    topology/sharding descriptor lives (``manifest["topology"]``) — what
    elastic resume reads to re-shard and to reject incompatible saves."""
    try:
        with open(os.path.join(tag_dir, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def quarantine_checkpoint(tag_dir: str, reason: str = "") -> Optional[str]:
    """Move a corrupt tag into ``<root>/quarantine/<tag>-<ts>`` — NEVER
    delete it (the bytes are evidence; an operator may hand-recover a
    shard).  Returns the new path, or None when the rename itself failed
    (cross-device, permissions — the tag is then left in place and the
    caller must skip it by step, not by absence)."""
    root = os.path.dirname(os.path.abspath(tag_dir))
    qdir = os.path.join(root, QUARANTINE_DIRNAME)
    ts = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    dest = os.path.join(qdir, f"{os.path.basename(tag_dir)}-{ts}")
    suffix = 0
    try:
        os.makedirs(qdir, exist_ok=True)
        while os.path.exists(dest):
            suffix += 1
            dest = os.path.join(
                qdir, f"{os.path.basename(tag_dir)}-{ts}.{suffix}"
            )
        os.rename(tag_dir, dest)
    except OSError as e:
        sys.stderr.write(
            f"Stoke -- could not quarantine corrupt checkpoint "
            f"{tag_dir!r}: {e}\n"
        )
        return None
    try:
        with open(os.path.join(dest, "QUARANTINED.json"), "w") as f:
            json.dump({"reason": reason, "ts": time.time(),
                       "original": tag_dir}, f, indent=2)
    except OSError:
        pass
    return dest


# tag name scheme shared with io_ops (a copy, so this module stays
# importable without torch; io_ops._TAG_RE is the authority and a test
# pins the two equal)
import re as _re

_TAG_RE = _re.compile(r"^stoke-(?P<name>.+)-backward-step-(?P<step>\d+)$")


def list_checkpoints(root: str, name: Optional[str]) -> List[Dict[str, Any]]:
    """All checkpoint tags under ``root`` (scoped to ``name`` when given),
    newest first."""
    out = []
    try:
        entries = os.listdir(root)
    except OSError:
        return out
    for entry in entries:
        m = _TAG_RE.match(entry)
        if m and (name is None or m.group("name") == name):
            out.append({
                "root": root,
                "tag": entry,
                "tag_dir": os.path.join(root, entry),
                "name": m.group("name"),
                "step": int(m.group("step")),
            })
    out.sort(key=lambda c: c["step"], reverse=True)
    return out


def find_latest_valid_checkpoint(
    roots: Sequence[Tuple[str, Optional[str]]],
    verify: bool = True,
    quarantine: bool = True,
    require_manifest: bool = False,
    on_quarantine: Optional[Callable[[str, Optional[str], str], None]] = None,
    validate_fn: Optional[Callable[[str], Tuple[bool, str]]] = None,
) -> Optional[Dict[str, Any]]:
    """Newest VALID checkpoint across ``roots`` (``(root, name)`` pairs;
    ``name=None`` matches any run name).

    Candidates are ordered by backward step across all roots; each is
    validated (:func:`verify_checkpoint`) before being trusted.  An invalid
    candidate is quarantined (renamed under ``<root>/quarantine/``, never
    deleted) and discovery falls back to the next-newest tag — the
    corrupted-latest-checkpoint acceptance path.  ``on_quarantine(tag_dir,
    quarantined_path, reason)`` is invoked per quarantined tag (telemetry
    counters, operator warnings).

    ``validate_fn(tag_dir) -> (ok, reason)`` runs AFTER the integrity
    checks pass: the facade's topology-descriptor compatibility
    check rides here, so a digest-clean checkpoint whose descriptor cannot
    serve the current run (different model) is quarantined with the remedy
    named instead of crashing the restore mid-flight.
    """
    candidates: List[Dict[str, Any]] = []
    for root, name in roots:
        if root:
            candidates.extend(list_checkpoints(root, name))
    candidates.sort(key=lambda c: c["step"], reverse=True)
    for cand in candidates:
        if not verify:
            # fast path for non-writer ranks after the writer already
            # quarantined the bad tags (multi-host resume protocol)
            if os.path.exists(os.path.join(cand["tag_dir"], "meta.json")):
                return cand
            continue
        ok, reason = verify_checkpoint(
            cand["tag_dir"], require_manifest=require_manifest
        )
        if ok and validate_fn is not None:
            try:
                ok, reason = validate_fn(cand["tag_dir"])
            except Exception as e:  # a broken validator must not resume
                ok, reason = False, f"descriptor validation failed ({e})"
        if ok:
            return cand
        dest = (
            quarantine_checkpoint(cand["tag_dir"], reason)
            if quarantine
            else None
        )
        if on_quarantine is not None:
            try:
                on_quarantine(cand["tag_dir"], dest, reason)
            except Exception:
                pass
    return None


# --------------------------------------------------------------------------- #
# chaos harness: deterministic fault injection
# --------------------------------------------------------------------------- #

#: kill modes ``kill_at_step`` understands
CHAOS_KILL_MODES: Tuple[str, ...] = ("sigterm", "sigkill", "exception")


@dataclass
class ChaosSpec:
    """Parsed fault-injection plan (``STOKE_CHAOS`` env /
    ``ResilienceConfig.chaos``).

    Spec grammar: comma-separated ``key=value`` pairs —
    ``kill_at_step=K`` (+ optional ``kill_mode=sigterm|sigkill|exception``),
    ``corrupt_save=N`` (corrupt the N-th checkpoint this process writes,
    1-based), ``wedge_at_step=K`` (+ ``wedge_s=S`` seconds) stalling the
    dispatch AFTER step K completes, ``kill_during_save=N`` (SIGKILL from
    INSIDE the N-th async save's background writer, after the payload and
    before ``meta.json`` — the half-staged death the manifest validator
    must detect and quarantine).  Example::

        STOKE_CHAOS="kill_at_step=5,kill_mode=sigterm"
    """

    kill_at_step: Optional[int] = None
    kill_mode: str = "sigterm"
    corrupt_save: Optional[int] = None
    wedge_at_step: Optional[int] = None
    wedge_s: float = 1.0
    kill_during_save: Optional[int] = None

    @property
    def active(self) -> bool:
        return (
            self.kill_at_step is not None
            or self.corrupt_save is not None
            or self.wedge_at_step is not None
            or self.kill_during_save is not None
        )


def parse_chaos(spec: Optional[str]) -> Optional[ChaosSpec]:
    """``"kill_at_step=5,kill_mode=sigterm"`` → :class:`ChaosSpec`; None /
    empty → None.  Unknown keys and malformed values raise ``ValueError``
    (a typo'd chaos plan silently injecting nothing would fake a green
    resilience test)."""
    if not spec or not spec.strip():
        return None
    fields = {f.name: f for f in dataclasses.fields(ChaosSpec)}
    out = ChaosSpec()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"Stoke -- chaos spec entry {part!r} is not key=value"
            )
        key, _, value = part.partition("=")
        key = key.strip()
        value = value.strip()
        if key not in fields:
            raise ValueError(
                f"Stoke -- unknown chaos key {key!r}; valid: "
                f"{sorted(fields)}"
            )
        if key == "kill_mode":
            if value not in CHAOS_KILL_MODES:
                raise ValueError(
                    f"Stoke -- chaos kill_mode {value!r} unknown; valid: "
                    f"{list(CHAOS_KILL_MODES)}"
                )
            out.kill_mode = value
        elif key == "wedge_s":
            out.wedge_s = float(value)
        else:
            try:
                setattr(out, key, int(value))
            except ValueError as e:
                raise ValueError(
                    f"Stoke -- chaos {key} needs an integer, got {value!r}"
                ) from e
    # an armed injector that can never fire is a fake-green chaos run —
    # the same contract as unknown keys: loud, never a silent no-op
    for key in ("kill_at_step", "corrupt_save", "wedge_at_step",
                "kill_during_save"):
        v = getattr(out, key)
        if v is not None and v < 1:
            raise ValueError(
                f"Stoke -- chaos {key} must be >= 1 (1-based), got {v}"
            )
    if out.wedge_s < 0:
        # 0 is legal: the wedge still fires, it just doesn't stall —
        # the tests use it to exercise injector logic without real sleeps
        raise ValueError(
            f"Stoke -- chaos wedge_s must be >= 0, got {out.wedge_s}"
        )
    return out


class ChaosInjector:
    """Runs one :class:`ChaosSpec` against a live run, deterministically.

    The facade drives it from the optimizer-step boundary
    (:meth:`on_step`), the checkpoint writer from :meth:`note_saved`, and
    the engine from its per-dispatch hook (:meth:`on_dispatch` — see
    ``StepEngine``'s dispatches).  ``kill_at_step`` fires only when THIS
    process itself crossed the step (a resumed process whose counter starts
    past K never re-fires, so a supervised restart makes forward progress).
    """

    def __init__(self, spec: Optional[ChaosSpec]):
        self.spec = spec
        self._saves_seen = 0
        self._async_payloads_seen = 0
        self._completed_step: Optional[int] = None
        self._resume_anchor: Optional[int] = None
        self._wedged = False
        self.corrupted: List[str] = []

    @property
    def active(self) -> bool:
        return self.spec is not None and self.spec.active

    def note_resumed(self, step: int) -> None:
        """Anchor the in-process step window after a resume (steps loaded
        from a checkpoint were not executed by this process) — both the
        kill and the wedge injector treat restored steps as already-fired."""
        self._completed_step = int(step)
        self._resume_anchor = int(step)

    def on_step(self, step: int, window: int = 1) -> None:
        """Optimizer-step-boundary hook: ``step`` is the counter AFTER the
        just-completed step(s); ``window`` how many steps the dispatch
        covered.  Fires ``kill_at_step=K`` when K lies inside the window
        this process just executed."""
        self._completed_step = int(step)
        if not self.active:
            return
        k = self.spec.kill_at_step
        if k is None or not (step - window < k <= step):
            return
        mode = self.spec.kill_mode
        sys.stderr.write(
            f"Stoke -- CHAOS: kill_at_step={k} firing at step {step} "
            f"(mode={mode})\n"
        )
        sys.stderr.flush()
        if mode == "exception":
            raise ChaosError(
                f"Stoke -- chaos-injected crash at optimizer step {step}"
            )
        sig = signal.SIGTERM if mode == "sigterm" else signal.SIGKILL
        os.kill(os.getpid(), sig)

    def on_dispatch(self, program: str) -> None:
        """Engine pre-dispatch hook: stalls the first dispatch after
        ``wedge_at_step`` completed steps for ``wedge_s`` seconds — the
        deterministic stand-in for a wedged collective the hang watchdog
        exists to catch."""
        if not self.active or self._wedged:
            return
        k = self.spec.wedge_at_step
        if k is None or self._completed_step is None:
            return
        if self._resume_anchor is not None and self._resume_anchor >= k:
            # a resumed process that restored step >= K already wedged in a
            # previous life; re-arming (the per-process _wedged flag resets
            # each restart) would wedge EVERY supervised attempt until the
            # restart budget burned out — forward progress requires the
            # wedge step to have been executed by THIS process
            return
        if self._completed_step >= k:
            self._wedged = True
            sys.stderr.write(
                f"Stoke -- CHAOS: wedging dispatch of {program!r} for "
                f"{self.spec.wedge_s}s after step {self._completed_step}\n"
            )
            time.sleep(self.spec.wedge_s)

    def on_async_payload(self, tag_dir: str) -> None:
        """Background-writer hook (``io_ops`` calls it between the payload
        write and ``meta.json``): ``kill_during_save=N`` SIGKILLs the
        process from inside the N-th async save — payload files on disk,
        no loadable marker, no manifest.  The resulting tag MUST read as a
        partial write to the resume-time validator and be quarantined,
        never resumed from."""
        self._async_payloads_seen += 1
        if not self.active:
            return
        if self.spec.kill_during_save == self._async_payloads_seen:
            sys.stderr.write(
                f"Stoke -- CHAOS: kill_during_save="
                f"{self.spec.kill_during_save} SIGKILLing mid-save of "
                f"{tag_dir}\n"
            )
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)

    def note_saved(self, tag_dir: str) -> None:
        """Checkpoint-writer hook: corrupts the bytes of the N-th save this
        process performed (``corrupt_save=N``, 1-based) — the quarantine
        path's deterministic trigger."""
        self._saves_seen += 1
        if not self.active:
            return
        if self.spec.corrupt_save == self._saves_seen:
            path = corrupt_checkpoint(tag_dir)
            if path:
                self.corrupted.append(path)


def corrupt_checkpoint(tag_dir: str, n_bytes: int = 64) -> Optional[str]:
    """Flip ``n_bytes`` in the middle of the largest payload file of a tag
    (never ``meta.json``/``manifest.json`` — the point is bit rot the
    digests catch, not an obviously-absent tag).  Returns the corrupted
    file path, or None when the tag has no payload files."""
    best = None
    for root, _dirs, files in os.walk(tag_dir):
        for name in files:
            if name in ("meta.json", MANIFEST_NAME):
                continue
            full = os.path.join(root, name)
            size = os.path.getsize(full)
            if best is None or size > best[0]:
                best = (size, full)
    if best is None or best[0] == 0:
        return None
    size, path = best
    offset = size // 2
    with open(path, "r+b") as f:
        f.seek(offset)
        chunk = f.read(n_bytes)
        f.seek(offset)
        f.write(bytes((~b) & 0xFF for b in chunk))
    sys.stderr.write(
        f"Stoke -- CHAOS: corrupted {len(chunk)} bytes of {path}\n"
    )
    return path


# --------------------------------------------------------------------------- #
# the monitor (facade-owned; host-side only — never touches the device)
# --------------------------------------------------------------------------- #

# per-signal install order of LIVE monitors, oldest first — lets overlapping
# monitor lifetimes (resume-while-preempted-run-open) uninstall in any order
# without stranding SIGTERM on a closed monitor's handler
_SIGNAL_STACKS: Dict[int, List[Tuple["ResilienceMonitor", Any]]] = {}


class ResilienceMonitor:
    """Owns the preemption flag, the chaos injector, and the
    ``resilience/*`` counters.  Installed by the facade when a
    ``ResilienceConfig`` is supplied; entirely host-side — the device
    work of a step is the same with or without it (the tests hold losses
    and parameters bit for bit and the dispatch count equal).

    The signal handler ONLY sets a flag (no IO, no locks, no registry —
    deadlock-safe by construction); the facade checks
    :attr:`preempt_requested` at each optimizer-step boundary and runs the
    drain→save→exit sequence there, on the training thread, with the step
    complete and the engine state consistent.
    """

    def __init__(self, cfg, registry, recorder=None):
        self.cfg = cfg
        self.registry = registry
        self.recorder = recorder
        spec = parse_chaos(
            cfg.chaos if cfg.chaos is not None
            else os.environ.get(CHAOS_ENV)
        )
        self.chaos = ChaosInjector(spec)
        self._preempted = threading.Event()
        self._preempt_signal: Optional[str] = None
        self._prev_handlers: Dict[int, Any] = {}
        self.restarts = int(os.environ.get(RESTART_ATTEMPT_ENV, "0") or 0)
        self.resumed_step: Optional[int] = None
        self.lost_steps: Optional[int] = None
        self.emergency_tag: Optional[str] = None
        self.elastic_resume: Optional[Dict[str, Any]] = None
        # pre-register so scrapes carry zeros before the first event
        registry.counter(
            "resilience/preemptions_total",
            help="preemption notices received (signal or explicit request)",
        )
        registry.counter(
            "resilience/emergency_saves_total",
            help="emergency checkpoints written on preemption",
        )
        registry.counter(
            "resilience/quarantined_ckpts_total",
            help="corrupt/partial checkpoint tags quarantined at resume",
        )
        registry.counter(
            "resilience/elastic_resumes_total",
            help="resumes that re-sharded state saved on a DIFFERENT "
            "topology (mesh/process-count/tier change)",
        )
        registry.gauge(
            "resilience/restarts",
            help="supervisor restart attempt this process is (0 = first run)",
        ).set(float(self.restarts))
        self._install_signal_handlers()

    # ------------------------------ signals ----------------------------- #

    def _install_signal_handlers(self) -> None:
        """Claim the preemption signals.  Deliberately does NOT chain to
        previous handlers: with resilience on, SIGTERM means "drain and
        save", and a chained default/recorder handler would terminate (or
        dump) mid-step — the exact data loss this subsystem removes.  Main
        thread only; elsewhere (test workers) the explicit
        :meth:`request_preemption` path still works."""
        for name in self.cfg.preempt_signals:
            signum = getattr(signal, name, None)
            if signum is None:
                continue
            try:
                prev = signal.signal(signum, self._on_signal)
            except (ValueError, OSError):
                # non-main thread / uncatchable signal — keep trying the
                # REST of the list: one bad name must not silently strip
                # the SIGTERM handler the whole subsystem depends on
                continue
            self._prev_handlers[signum] = prev
            _SIGNAL_STACKS.setdefault(signum, []).append((self, prev))

    def _on_signal(self, signum, frame) -> None:
        # flag only — every heavier action (drain, save, bundle, exit)
        # happens at the next step boundary on the training thread
        self._preempt_signal = signal.Signals(signum).name
        self._preempted.set()

    def uninstall_signal_handlers(self) -> None:
        # Monitors can overlap (resume constructs a new Stoke while the
        # preempted one is still open), and
        # they may close in either order.  A per-signal stack keeps the
        # handler chain honest: a middle removal hands its saved `prev` up
        # to the monitor above (so the final close restores the ORIGINAL
        # handler, not a closed monitor's flag-setter), and a top removal
        # only touches the live handler if it is still ours.
        for signum in list(self._prev_handlers):
            stack = _SIGNAL_STACKS.get(signum, [])
            idx = next(
                (i for i, (m, _) in enumerate(stack) if m is self), None
            )
            if idx is None:
                continue
            _, prev = stack.pop(idx)
            if idx < len(stack):
                # middle removal: the monitor above inherits our prev
                above, _ = stack[idx]
                stack[idx] = (above, prev)
                continue
            try:
                if signal.getsignal(signum) == self._on_signal:
                    signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()

    # ------------------------------ surface ----------------------------- #

    @property
    def preempt_requested(self) -> bool:
        return self._preempted.is_set()

    @property
    def preempt_signal(self) -> Optional[str]:
        return self._preempt_signal

    def request_preemption(self, reason: str = "manual") -> None:
        """Programmatic preemption notice (tests, cluster agents that
        learn about preemption out-of-band, e.g. a metadata-server poll)."""
        self._preempt_signal = reason
        self._preempted.set()

    def note_preemption_honored(self) -> None:
        """Counted at the boundary, not in the handler (the registry takes
        locks; a signal handler must not)."""
        self.registry.counter("resilience/preemptions_total").inc()

    def note_emergency_saved(self, tag_dir: str) -> None:
        self.emergency_tag = tag_dir
        self.registry.counter("resilience/emergency_saves_total").inc()

    def note_quarantined(self, tag_dir: str, dest: Optional[str],
                         reason: str) -> None:
        self.registry.counter("resilience/quarantined_ckpts_total").inc()

    def note_elastic_resume(
        self,
        saved: Optional[Dict[str, Any]],
        current: Optional[Dict[str, Any]],
    ) -> None:
        """Record one topology-elastic resume: the restored
        checkpoint was saved under a different (mesh, process count, tier,
        shard_updates) than this run — params/opt/EF state were re-sharded
        onto the new layout at load."""
        self.elastic_resume = {"from": saved, "to": current}
        self.registry.counter("resilience/elastic_resumes_total").inc()

    def note_resumed(self, step: int,
                     lost_steps: Optional[int] = None) -> None:
        """Record where this run resumed from: ``resumed_step`` gauges the
        restored optimizer step; ``lost_steps`` the optimizer steps a
        newer-but-unusable tag had recorded beyond the resumed one (0 for
        a clean emergency save — it runs AT the boundary; >0 when resume
        fell back past a quarantined tag)."""
        self.resumed_step = int(step)
        self.registry.gauge(
            "resilience/resumed_step",
            help="optimizer step this run resumed from",
        ).set(float(step))
        if lost_steps is not None:
            self.lost_steps = max(0, int(lost_steps))
            self.registry.gauge(
                "resilience/lost_steps",
                help="steps the preempted run lost beyond the resumed tag",
            ).set(float(self.lost_steps))
        self.chaos.note_resumed(step)

    def exit_or_raise(self, step: int, tag_dir: Optional[str]) -> None:
        """Leave the process with the resumable exit code (the supervisor
        contract), or raise :class:`PreemptedError` for in-process callers.
        ``os._exit``: a preempted pod host is seconds from disappearing —
        interpreter teardown (atexit handlers, writer thread joins) can hang
        longer than the grace window, and everything durable was already
        flushed by the caller."""
        if not self.cfg.exit_on_preempt:
            self._preempted.clear()  # an in-process caller may resume + retry
            raise PreemptedError(step, tag_dir, self.cfg.exit_code)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(self.cfg.exit_code)

    def event_fields(self) -> Dict[str, Optional[float]]:
        """The ``resilience/*`` JSONL step-event columns (the registry
        contract: absent config → keys never appear; present → counters
        ride every record)."""
        def _val(name):
            inst = self.registry.get(name)
            return None if inst is None else float(inst.value)

        return {
            "resilience/preemptions": _val("resilience/preemptions_total"),
            "resilience/emergency_saves": _val(
                "resilience/emergency_saves_total"
            ),
            "resilience/quarantined": _val(
                "resilience/quarantined_ckpts_total"
            ),
            "resilience/restarts": float(self.restarts),
            "resilience/resumed_step": (
                None if self.resumed_step is None
                else float(self.resumed_step)
            ),
            "resilience/lost_steps": (
                None if self.lost_steps is None else float(self.lost_steps)
            ),
            "resilience/elastic_resumes": _val(
                "resilience/elastic_resumes_total"
            ),
        }

    def summary(self) -> Dict[str, Any]:
        """End-of-run resilience accounting (the ``Stoke.resilience_summary``
        surface)."""
        def _int(name):
            inst = self.registry.get(name)
            return 0 if inst is None else int(inst.value)

        return {
            "restarts": self.restarts,
            "preemptions": _int("resilience/preemptions_total"),
            "emergency_saves": _int("resilience/emergency_saves_total"),
            "quarantined_ckpts": _int("resilience/quarantined_ckpts_total"),
            "resumed_step": self.resumed_step,
            "lost_steps": self.lost_steps,
            "emergency_tag": self.emergency_tag,
            "elastic_resumes": _int("resilience/elastic_resumes_total"),
            "elastic_resume": self.elastic_resume,
            "chaos_active": self.chaos.active,
        }

    def close(self) -> None:
        self.uninstall_signal_handlers()
