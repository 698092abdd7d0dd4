"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The libraries go into ``build/stoke_tpu_torch/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. :func:`build` starts one ``nvcc``
per source, all at once; each build counts as a compile in the telemetry
(:mod:`stoke_tpu_torch.telemetry.collectors`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

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

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is, for its current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    process per source, started together. Returns the seconds each build
    took (0.0 where the library was already there). The compiler's report
    (registers, shared memory, spills) is kept beside each library as
    ``<library>.log``. Raises ``RuntimeError`` with the compiler's output
    if a build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = None
        procs = {}
        seconds = {}
        for name in names:
            out = library_path(name)
            if out.exists():
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
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)
            collectors.note_compile(seconds[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return seconds


def build_log(name: str) -> Optional[str]:
    """The compiler's report of the current build of ``name``, if built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
    return lib
