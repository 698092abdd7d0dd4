"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The libraries go into ``build/stoke_tpu_torch/`` at the root of the
checkout, or into the directory :func:`set_build_dir` names for the
process (a ``CompileConfig``'s persistent kernel cache,
:func:`stoke_tpu_torch.compile_cache.install_persistent_kernel_cache`).
A library is named by a hash of its sources, the flags and the toolchain
that builds it (the ``nvcc --version`` release line), so an edited
source, other flags or another compiler build another library and an
unchanged one is reused. :func:`build` starts one ``nvcc`` per source,
all at once; each build counts as a compile in the telemetry
(:mod:`stoke_tpu_torch.telemetry.collectors`), and its record
``<library>.json`` beside the library keeps the build's seconds.
:func:`load` of a missing library builds every missing one with it: a
path that needs one kernel needs the others soon, and a cold start then
pays the slowest build, not their sum. Each library :func:`load` loads is
told to the listeners of :func:`on_load` (the compile cache's hits and
misses) as a :class:`LoadRecord`.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

from stoke_tpu_torch.telemetry import collectors

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "stoke_tpu_torch"
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "paged_verify", "quant")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class LoadRecord(NamedTuple):
    """One library :func:`load` loaded: its source's name, its path,
    whether this process built it, and the load's seconds (its build's
    included where it built)."""

    name: str
    path: Path
    built: bool
    load_s: float


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_build_dir: Optional[Path] = None
#: builds below this many seconds are not kept in the build directory
#: :func:`set_build_dir` named (a ``CompileConfig``'s
#: ``min_compile_time_s``): they go into ``BUILD_DIR``
_min_keep_s = 0.0
#: where each source's library was found or built in this process
_where: Dict[str, Path] = {}
#: the libraries this process built
_built_here: set = set()
_loads: List[LoadRecord] = []
_listeners: List[Callable[[], Optional[Callable[[LoadRecord], None]]]] = []
_nvcc_release: Optional[str] = None
#: wall seconds of every build call this process ran that compiled
#: something
_built_wall = 0.0


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install location."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH (the port's "
        "kernels are built from csrc/ at first use)"
    )


def nvcc_release() -> str:
    """The release line of ``nvcc --version`` (``Cuda compilation tools,
    release 12.8, V12.8.93``), read once a process; ``"no nvcc"`` where
    there is none (nothing is built there)."""
    global _nvcc_release
    if _nvcc_release is None:
        try:
            out = subprocess.run([nvcc_path(), "--version"],
                                 capture_output=True, text=True,
                                 timeout=60).stdout
            lines = [ln.strip() for ln in out.splitlines()
                     if "release" in ln]
            _nvcc_release = lines[0] if lines else out.strip()
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _nvcc_release = "no nvcc"
    return _nvcc_release


def build_dir() -> Path:
    """Where libraries are built and looked for in this process."""
    return _build_dir if _build_dir is not None else BUILD_DIR


def set_build_dir(path, min_keep_s: float = 0.0) -> bool:
    """Build into ``path`` for the rest of the process; builds that take
    less than ``min_keep_s`` seconds are not kept there. The first caller
    wins (libraries already loaded stay loaded): True when ``path`` owns
    the build directory, False when another directory does."""
    global _build_dir, _min_keep_s
    path = Path(path).resolve()
    with _lock:
        if _build_dir is not None:
            return _build_dir == path
        path.mkdir(parents=True, exist_ok=True)
        _build_dir = path
        _min_keep_s = float(min_keep_s)
        return True


def library_path(name: str, release: Optional[str] = None) -> Path:
    """Where the library of ``csrc/<name>.cu`` is, for its current sources,
    flags and toolchain (``release``: the ``nvcc --version`` release line,
    :func:`nvcc_release` by default), in the build directory."""
    release = nvcc_release() if release is None else release
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(b"\x00" + release.encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _found(name: str) -> Path:
    """The library of ``name`` this process found or built, else where it
    belongs in the build directory."""
    path = _where.get(name)
    return path if path is not None and path.exists() else \
        library_path(name)


def built_seconds() -> float:
    """Wall seconds of every kernel build this process has run."""
    return _built_wall


def build_record(path: Path) -> dict:
    """The build record beside the library at ``path``: ``build_s``, its
    own ``nvcc`` seconds, and ``share_s``, its share of the wall seconds
    of the parallel build that made it (the call's wall over the libraries
    it built). Raises ``OSError`` where there is none and ``ValueError``
    where it is not such a record."""
    rec = json.loads(Path(path).with_suffix(".json").read_text())
    if not isinstance(rec, dict) or not isinstance(
            rec.get("share_s"), (int, float)):
        raise ValueError(f"not a build record: {rec!r}")
    return rec


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    process per source, started together. Returns the seconds each build
    took (0.0 where the library was already there). The compiler's report
    (registers, shared memory, spills) is kept beside each library as
    ``<library>.log``, and its build record (:func:`build_record`) as
    ``<library>.json``. Raises ``RuntimeError`` with the compiler's output
    if a build fails."""
    global _built_wall
    with _lock:
        t_call = time.perf_counter()
        build_dir().mkdir(parents=True, exist_ok=True)
        nvcc = None
        procs = {}
        seconds = {}
        for name in names:
            out = _found(name)
            if out.exists():
                _where[name] = out
                seconds[name] = 0.0
                continue
            nvcc = nvcc or nvcc_path()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp,
                out,
                time.perf_counter(),
            )
        if procs:
            collectors.compile_starting()
        failed, made = [], []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                out.with_suffix(".log").write_text(log)
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            if _build_dir is not None and seconds[name] < _min_keep_s:
                # below the persistent cache's threshold: not kept there
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                out = BUILD_DIR / out.name
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            _where[name] = out
            _built_here.add(out)
            made.append(name)
            collectors.note_compile(seconds[name])
        if procs:
            wall = time.perf_counter() - t_call
            _built_wall += wall
            for name in made:
                _write_record(_where[name], {
                    "build_s": round(seconds[name], 6),
                    "share_s": round(wall / len(made), 6),
                    "nvcc": nvcc_release()})
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return seconds


def _write_record(path: Path, rec: dict) -> None:
    """Atomic (tmp + rename, pid-unique): processes sharing a build
    directory cannot tear a record."""
    tmp = path.with_suffix(f".json.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(rec))
    os.replace(tmp, path.with_suffix(".json"))


def build_log(name: str) -> Optional[str]:
    """The compiler's report of the current build of ``name``, if built."""
    log = _found(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def on_load(listener: Callable[[LoadRecord], None]) -> None:
    """Call ``listener`` with each :class:`LoadRecord` from now on (held
    weakly where it is a bound method, so the listener's owner may go)."""
    with _lock:
        _listeners.append(
            weakref.WeakMethod(listener) if hasattr(listener, "__self__")
            else (lambda: listener))


def loads() -> List[LoadRecord]:
    """Every library this process has loaded, in order."""
    return list(_loads)


def _note_load(rec: LoadRecord) -> None:
    with _lock:
        _loads.append(rec)
        _listeners[:] = [ref for ref in _listeners if ref() is not None]
        listeners = [ref() for ref in _listeners]
    for listener in listeners:
        if listener is not None:
            listener(rec)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed
    (with every missing library of ``SOURCES``). A library once loaded
    serves the whole process."""
    lib = _libs.get(name)
    if lib is None:
        t0 = time.perf_counter()
        build(SOURCES if name in SOURCES else [name])
        with _lock:
            lib = _libs.get(name)
            rec = None
            if lib is None:
                path = _found(name)
                lib = ctypes.CDLL(str(path))
                _libs[name] = lib
                rec = LoadRecord(name, path, path in _built_here,
                                 time.perf_counter() - t0)
        if rec is not None:
            _note_load(rec)
    return lib
