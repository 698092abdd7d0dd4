"""The persistent compile cache of the port: its kernel libraries kept
across processes.

The port's counterpart of ``stoke_tpu/compile_cache.py``. XLA compiles
every jitted program; the port compiles two things only: the ``nvcc``
build of a kernel library (``ops/_build.py``, seconds a source) and the
CUDA-graph capture of a training window (milliseconds, and bound to the
storage of the ``Stoke`` that captured it). Only the first outlives a
process, so the three layers of the JAX cache become:

1. **The process's loaded libraries** (the process program cache): a
   library once loaded serves every ``Stoke`` in the process, so a second
   construction builds nothing. A captured graph is never shared: it
   holds the first ``Stoke``'s parameter and optimizer storage, and a
   replay for another run would step the first run's state.
2. **The persistent kernel cache** (the persistent XLA cache,
   ``xla_cache=True``): :func:`install_persistent_kernel_cache` makes
   ``<cache_dir>/kernels`` the process's build directory, so a warm
   process loads the libraries a cold one built. Libraries are named by
   their sources, flags and ``nvcc`` release line, so another compiler
   never loads a stale one. Builds under ``min_compile_time_s`` are not
   kept there. On the CPU nothing is built; it warns once, as the JAX
   cache refuses the CPU backend.
3. **The ledger** (``aot=True``): the library directory itself. Each
   library the process loads (``ops/_build.on_load``) is a miss where
   this process built it and a hit where it was there; a hit credits the
   seconds in the library's build record (``<library>.json``, its share
   of the cold build's wall) as reclaimed. A capture is paid again by
   every process, so nothing credits it.

``serialize_executables`` is accepted with no effect: a CUDA graph cannot
be serialised, and the kernel library is already the artifact.

Failure policy (the JAX one): a cache fault (an unreadable or corrupt
build record, a file system error) degrades to a plain run with one
warning and a ``serialize_errors`` count. A failed kernel build still
raises.
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Any, Dict, Optional

from stoke_tpu_torch.ops import _build

#: the persistent kernel directory that owns the process's build
#: directory (first caller wins)
_kernel_cache_installed: set = set()
_kernel_cache_lock = threading.Lock()
#: one CPU warning a process
_cpu_refusal_warned = False


def install_persistent_kernel_cache(cache_dir: str,
                                    min_compile_time_s: float = 0.0) -> bool:
    """Make ``cache_dir`` the process's kernel build directory
    (``ops/_build.set_build_dir``). Idempotent; the FIRST caller wins, as
    with the process-global jax knob (libraries already loaded stay
    loaded, and the directory is content-addressed, so sharing it is
    safe). Returns True when this directory owns the build directory,
    False when another does or the process has no card (it warns once:
    nothing is built on the CPU)."""
    global _cpu_refusal_warned
    import torch

    with _kernel_cache_lock:
        if cache_dir in _kernel_cache_installed:
            return True
        if _kernel_cache_installed:
            return False
        if not torch.cuda.is_available():
            if not _cpu_refusal_warned:
                _cpu_refusal_warned = True
                warnings.warn(
                    "Stoke -- persistent kernel cache disabled without a "
                    "CUDA device (the CPU runs the kernels' plain "
                    "versions and builds nothing)")
            return False
        try:
            owned = _build.set_build_dir(cache_dir, min_compile_time_s)
        except OSError as e:
            warnings.warn(
                f"Stoke -- persistent kernel cache unavailable ({e!r}); "
                f"kernels build into the default directory")
            return False
        if owned:
            _kernel_cache_installed.add(cache_dir)
        return owned


def kernel_cache_active() -> bool:
    """True when some persistent kernel directory owns the process's build
    directory."""
    return bool(_kernel_cache_installed)


class CompileCache:
    """One per :class:`~stoke_tpu_torch.facade.Stoke` run with a
    ``CompileConfig``. It books each kernel library the process loads from
    the persistent directory (``ops/_build.on_load``); at construction it
    books the libraries the process already holds from there (layer 1:
    this run does not pay them).

    Counters (in the run's telemetry registry; ``hit_s_total`` feeds the
    goodput ledger's ``compile_cached`` share):

    - ``compile_cache/hits_total`` / ``misses_total``: libraries loaded
      from the directory / built by this process.
    - ``compile_cache/hit_s_total``: the seconds the hits' loads took:
      the cached warm-start cost.
    - ``compile_cache/saved_s_total``: the hits' recorded build seconds,
      which this process did not pay: the reclaimed compile seconds.
    - ``compile_cache/serialize_errors_total``: unreadable build records.
    """

    def __init__(self, cfg, registry=None):
        self.cfg = cfg
        self.registry = registry
        self.hits = 0
        self.misses = 0
        self.serialize_errors = 0
        self.saved_compile_s = 0.0
        self._booked: set = set()
        self._lock = threading.Lock()
        self._warned = False
        os.makedirs(cfg.cache_dir, exist_ok=True)
        self._kernels = os.path.join(cfg.cache_dir, "kernels")
        installed = False
        if cfg.xla_cache:
            installed = install_persistent_kernel_cache(
                self._kernels, cfg.min_compile_time_s)
        self.kernel_cache = installed or kernel_cache_active()
        if registry is not None:
            for name, help_ in (
                ("hits_total", "kernel libraries loaded from the cache"),
                ("misses_total", "kernel libraries built by this process"),
                ("hit_s_total", "seconds of the cached libraries' loads"),
                ("saved_s_total", "cold build seconds reclaimed by hits"),
                ("serialize_errors_total", "unreadable build records"),
            ):
                registry.counter(f"compile_cache/{name}", help=help_)
        if cfg.aot:
            for rec in _build.loads():
                self._book(rec, held=True)
            _build.on_load(self._book)

    def _directory(self) -> str:
        """The directory whose libraries are hits: the persistent one that
        owns the process's build directory (this run's or another's), else
        this run's own."""
        if kernel_cache_active():
            return os.path.realpath(str(_build.build_dir()))
        return os.path.realpath(self._kernels)

    def _book(self, rec, held: bool = False) -> None:
        """Book one loaded library: a miss where this process built it, a
        hit crediting its build record where it was in the directory.
        ``held``: loaded before this run, so this run paid nothing for it
        (a hit wherever the directory holds it)."""
        if rec.built and not held:
            self._count_miss(rec)
            return
        if os.path.realpath(str(rec.path.parent)) != self._directory():
            return
        with self._lock:
            if rec.path in self._booked:
                return
            self._booked.add(rec.path)
            self.hits += 1
        self._inc("compile_cache/hits_total")
        if not held:
            self._inc("compile_cache/hit_s_total", rec.load_s)
        try:
            saved = float(_build.build_record(rec.path)["share_s"])
        except (OSError, ValueError) as e:
            self._note_error(rec.name, e)
            return
        with self._lock:
            self.saved_compile_s += saved
        self._inc("compile_cache/saved_s_total", saved)

    def _count_miss(self, rec) -> None:
        with self._lock:
            if rec.path in self._booked:
                return
            self._booked.add(rec.path)
            self.misses += 1
        self._inc("compile_cache/misses_total")

    # ------------------------------------------------------------------ #
    # bookkeeping
    # ------------------------------------------------------------------ #

    def _inc(self, name: str, value: float = 1.0) -> None:
        if self.registry is not None:
            self.registry.counter(name).inc(value)

    def _note_error(self, library: str, err) -> None:
        with self._lock:
            self.serialize_errors += 1
        self._inc("compile_cache/serialize_errors_total")
        if not self._warned:
            self._warned = True
            warnings.warn(
                f"Stoke -- compile cache read failed for the {library!r} "
                f"library's build record: {err!r}; its seconds are not "
                f"credited (warned once per run)")

    def stats(self) -> Dict[str, Any]:
        """Run-level cache accounting (``Stoke.compile_cache.stats()``),
        with the JAX cache's keys; ``xla_cache_active`` reads whether the
        persistent kernel cache owns the build directory, ``entries`` the
        libraries booked."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "saved_compile_s": round(self.saved_compile_s, 6),
            "serialize_errors": self.serialize_errors,
            "cache_dir": self.cfg.cache_dir,
            "xla_cache_active": self.kernel_cache,
            "entries": len(self._booked),
        }
