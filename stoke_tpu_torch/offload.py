"""Offload: the disk tier of the optimizer state, the pinned host tier that
streams it through the card at the update, and the device-to-host staging
of an async checkpoint.

Counterpart of ``stoke_tpu/offload.py``: :class:`DiskOptimizerStore` and
:func:`reclaim_stale_spills` (``:46-228``), :class:`StagedSnapshot`,
:func:`stage_tree`, :func:`drain_staged` and :func:`staged_nbytes`
(``:230-400``, :data:`MAX_STAGED` = 2), and the host tier the JAX engine
gets from a ``pinned_host`` memory kind (``stoke_tpu/engine.py:553-650``),
here :class:`HostOptimizerState`.

**Disk tier.** :class:`DiskOptimizerStore` writes every tensor of a tree to
a memory-mapped file of its raw bytes (bfloat16 and float16 survive as
their bits) and frees the tensors' memory in place
(``untyped_storage().resize_(0)``), except those of ``protect``; ``load``
builds new tensors on their devices from the files. The files are runtime
state, deleted when the store closes or is collected.

**Host tier.** :class:`HostOptimizerState` keeps every optimizer state
tensor shaped like its parameter in pinned host memory between steps. At
the update it streams the state through the card in leaf groups: for each
group the state is copied into one bounded device buffer (the largest
group's size), the optimizer steps that group's parameters, and the state
is copied back, all on the current stream. The math is the optimizer's
own, so the parameters are bit for bit those without offload, and the
copies are between pinned memory and a static buffer, so a window
captured as a CUDA graph replays them as memcpy nodes. A host read of the
state (a checkpoint) must first synchronize the stream.

**Staging.** An async save hands its state to :func:`stage_tree`. The next
apply updates the parameters and the optimizer state in place (torch's
counterpart of JAX's donation), so the snapshot first takes one
device-to-device copy of each CUDA tensor on the current stream, then
issues ``non_blocking`` copies of those into pinned host buffers on a side
copy stream and records an event. :meth:`StagedSnapshot.resolve` (the
writer thread) waits on the event and returns host arrays; the main
thread never calls ``.cpu()``, ``.item()`` or ``synchronize``. The pinned
buffers come from the Stoke's :class:`PinnedPool`, allocated once and
reused (:meth:`StagedSnapshot.release` returns them) until the Stoke
closes; at most :data:`MAX_STAGED` snapshots are unresolved at once. On the CPU the snapshot is a clone, and every copy is synchronous.
"""

from __future__ import annotations

import os
import shutil
import threading
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = [
    "DiskOptimizerStore",
    "HostOptimizerState",
    "PinnedPool",
    "StagedSnapshot",
    "drain_staged",
    "reclaim_stale_spills",
    "stage_tree",
    "staged_nbytes",
]


# --------------------------------------------------------------------------- #
# the disk tier
# --------------------------------------------------------------------------- #


def _cleanup_dirs(directory: str, cleanup_root: Optional[str] = None) -> None:
    shutil.rmtree(directory, ignore_errors=True)
    shutil.rmtree(directory + ".next", ignore_errors=True)
    if cleanup_root is not None:
        shutil.rmtree(cleanup_root, ignore_errors=True)


def reclaim_stale_spills(base: str) -> None:
    """Best-effort removal of spill dirs left by DEAD processes (a killed
    run cannot clean up after itself). Each live run records its pid in
    ``<run-dir>/pid``; sibling run dirs whose recorded process no longer
    exists are deleted. Safe with concurrent runs on the same mount."""
    try:
        entries = os.listdir(base)
    except OSError:
        return
    for name in entries:
        run_dir = os.path.join(base, name)
        pid_file = os.path.join(run_dir, "pid")
        try:
            with open(pid_file) as f:
                pid = int(f.read().strip())
        except (OSError, ValueError):
            continue
        try:
            os.kill(pid, 0)  # probe only; signal 0 delivers nothing
        except ProcessLookupError:
            shutil.rmtree(run_dir, ignore_errors=True)
        except OSError:
            pass  # e.g. EPERM: process exists under another uid — keep


def _free(t: torch.Tensor) -> None:
    """Release a tensor's memory in place (its other references see an
    empty storage until it is refilled); a storage torch does not own (one
    over a numpy array) is left to its references."""
    storage = t.untyped_storage()
    if storage.resizable():
        storage.resize_(0)


class DiskOptimizerStore:
    """Spill and restore a tree of tensors (the optimizer state) through
    memory-mapped files.

    Usage::

        store.store(state)          # write every tensor, free its memory
        state = store.load()        # new tensors on their devices
    """

    def __init__(self, directory: str, cleanup_root: Optional[str] = None):
        self._dir = os.path.abspath(directory)
        self._cleanup_root = cleanup_root
        self._spec: Optional[tuple] = None  # (treespec, per-leaf records)
        # spill files are runtime-only state: reclaim them when this store is
        # garbage-collected or the interpreter exits
        self._finalizer = weakref.finalize(
            self, _cleanup_dirs, self._dir, cleanup_root
        )

    @property
    def spilled(self) -> bool:
        return self._spec is not None

    @property
    def directory(self) -> str:
        return self._dir

    def files(self) -> List[str]:
        """The spill files of the current spill (paths)."""
        if self._spec is None:
            return []
        return [os.path.join(self._dir, rec[2]) for kind, rec in self._spec[1]
                if kind == "tensor"]

    def store(self, tree: Any, protect: Any = None) -> None:
        """Write every tensor of ``tree`` to disk and free its memory;
        replaces any previous spill. ``protect``: a tree whose tensors must
        NOT be freed even where ``tree`` holds them (or a view of their
        storage), e.g. the model's parameters when an optimizer keeps them
        in its state."""
        tmp = self._dir + ".next"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        leaves, spec = tree_flatten(tree)
        records = []
        for i, leaf in enumerate(leaves):
            if not torch.is_tensor(leaf):
                records.append(("static", leaf))
                continue
            base = f"leaf{i}.npy"
            data = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
            # raw bytes: a .npy memmap has no bfloat16, so the dtype rides
            # in the record and the bytes are viewed back at load (copied
            # by torch: a numpy view of the tensor would pin its storage)
            mm = np.lib.format.open_memmap(
                os.path.join(tmp, base), mode="w+", dtype=np.uint8,
                shape=(data.numel(),))
            torch.from_numpy(mm).copy_(data)
            mm.flush()
            del mm
            records.append(("tensor", (tuple(leaf.shape), leaf.dtype, base,
                                       leaf.device)))
        keep = {t.untyped_storage().data_ptr()
                for t in tree_flatten(protect)[0] if torch.is_tensor(t)}
        for leaf in leaves:
            if (torch.is_tensor(leaf)
                    and leaf.untyped_storage().data_ptr() not in keep):
                _free(leaf)
        # the new spill replaces the old only once it is complete
        shutil.rmtree(self._dir, ignore_errors=True)
        os.replace(tmp, self._dir)
        self._spec = (spec, records)

    def load(self) -> Any:
        """New tensors, on their original devices, from the spill."""
        if self._spec is None:
            raise RuntimeError("DiskOptimizerStore.load() before store()")
        spec, records = self._spec
        leaves = []
        for kind, rec in records:
            if kind == "static":
                leaves.append(rec)
                continue
            shape, dtype, base, device = rec
            raw = np.load(os.path.join(self._dir, base), mmap_mode="r")
            t = torch.empty(shape, dtype=dtype, device=device)
            t.reshape(-1).view(torch.uint8).copy_(
                torch.from_numpy(np.array(raw)))
            leaves.append(t)
        return tree_unflatten(leaves, spec)

    def close(self) -> None:
        self._finalizer.detach()
        _cleanup_dirs(self._dir, self._cleanup_root)
        self._spec = None


# --------------------------------------------------------------------------- #
# the pinned host tier
# --------------------------------------------------------------------------- #


#: the least elements of a leaf group (fp32 state, per state key): groups
#: gather consecutive parameters up to the larger of this and the largest
#: parameter, so the device buffer is about one large leaf's state
GROUP_MIN_ELEMS = 8 * 2**20


class HostOptimizerState:
    """The optimizer state in pinned host memory between steps, streamed
    through one bounded device buffer at the update (see the module
    docstring).

    Args:
        optimizer: the ``torch.optim`` optimizer; its state tensors shaped
            like their parameter are kept on the host, scalars (a
            capturable step count) stay on the device.
        device: the device the update runs on. The host tensors are
            pinned when it is a CUDA device (the copies must be
            asynchronous to sit inside a captured window); the CPU has no
            pinned memory.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 device: torch.device):
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"
        params = [p for g in optimizer.param_groups for p in g["params"]]
        limit = max([GROUP_MIN_ELEMS] + [p.numel() for p in params])
        self.groups: List[List[torch.Tensor]] = []
        size = 0
        for p in params:
            if not self.groups or size + p.numel() > limit:
                self.groups.append([])
                size = 0
            self.groups[-1].append(p)
            size += p.numel()
        self._host: Dict[Tuple[int, str], torch.Tensor] = {}
        self._buffers: Dict[torch.dtype, torch.Tensor] = {}
        self._prev: Dict[torch.dtype, torch.Tensor] = {}
        #: set when the device buffers were (re)allocated: captured windows
        #: hold their addresses
        self.reallocated = False

    def _offloaded(self, p: torch.Tensor, v: Any) -> bool:
        return torch.is_tensor(v) and v.dim() > 0 and v.shape == p.shape

    def adopt(self) -> bool:
        """Move every state tensor shaped like its parameter that is not
        this tier's host tensor (the state a first step or a load created)
        into its host tensor; returns whether any moved (the buffers are
        then sized anew)."""
        moved = False
        for p, state in self.optimizer.state.items():
            for key, v in list(state.items()):
                if not self._offloaded(p, v):
                    continue
                host = self._host.get((id(p), key))
                if host is v:
                    continue
                if host is None or (host.shape, host.dtype) != (v.shape,
                                                                v.dtype):
                    host = torch.empty(v.shape, dtype=v.dtype, device="cpu",
                                       pin_memory=self.pin)
                    self._host[(id(p), key)] = host
                host.copy_(v)
                state[key] = host
                moved = True
        if moved:
            self._size_buffers()
        return moved

    def _group_state(self, group: Sequence[torch.Tensor]):
        """``[(param, key, host tensor)]`` of a group, in a fixed order."""
        out = []
        for p in group:
            for key, v in self.optimizer.state.get(p, {}).items():
                if self._offloaded(p, v):
                    out.append((p, key, v))
        return out

    def _size_buffers(self) -> None:
        need: Dict[torch.dtype, int] = {}
        for group in self.groups:
            per: Dict[torch.dtype, int] = {}
            for _, _, v in self._group_state(group):
                per[v.dtype] = per.get(v.dtype, 0) + v.numel()
            for dt, n in per.items():
                need[dt] = max(need.get(dt, 0), n)
        for dt, n in need.items():
            buf = self._buffers.get(dt)
            if buf is None or buf.numel() < n:
                self._buffers[dt] = torch.empty(n, dtype=dt,
                                                device=self.device)
                self._prev.pop(dt, None)
                self.reallocated = True

    @property
    def buffer_bytes(self) -> int:
        """Bytes of the streaming buffer on the device (the largest leaf
        group's state; twice that under fp16, whose skip keeps a copy)."""
        return sum(b.numel() * b.element_size()
                   for b in (*self._buffers.values(), *self._prev.values()))

    @property
    def host_tensors(self) -> List[torch.Tensor]:
        return list(self._host.values())

    def step(self, finite: Optional[torch.Tensor] = None) -> None:
        """``optimizer.step()`` group by group through the device buffer.
        ``finite`` (fp16): a bool scalar on the device; where it is false
        each group's state is put back as it was before the step (the
        parameters and the device scalars are the caller's to put back).
        A group whose parameters have no state yet (the first step) steps
        on the device and its new state is adopted afterwards; state a
        load created is adopted first."""
        self.adopt()
        opt = self.optimizer
        saved = [g["params"] for g in opt.param_groups]
        try:
            for group in self.groups:
                members = set(group)
                views = []
                offs: Dict[torch.dtype, int] = {}
                for p, key, host in self._group_state(group):
                    buf = self._buffers[host.dtype]
                    o = offs.get(host.dtype, 0)
                    view = buf[o:o + host.numel()].view(host.shape)
                    offs[host.dtype] = o + host.numel()
                    view.copy_(host, non_blocking=True)
                    opt.state[p][key] = view
                    views.append((p, key, host, view))
                if finite is not None:
                    for dt, n in offs.items():
                        prev = self._prev.get(dt)
                        if prev is None:
                            prev = self._prev[dt] = torch.empty_like(
                                self._buffers[dt])
                        prev[:n].copy_(self._buffers[dt][:n])
                for g, ps in zip(opt.param_groups, saved):
                    g["params"] = [p for p in ps if p in members]
                opt.step()
                if finite is not None:
                    for dt, n in offs.items():
                        live = self._buffers[dt][:n]
                        torch.where(finite, live, self._prev[dt][:n],
                                    out=live)
                    streamed = {id(v) for *_, v in views}
                    for p in group:
                        for v in opt.state.get(p, {}).values():
                            # state this step created: zero when skipped,
                            # as the engine's put-back does
                            if (self._offloaded(p, v)
                                    and id(v) not in streamed):
                                torch.where(finite, v, torch.zeros(
                                    (), dtype=v.dtype, device=v.device),
                                    out=v)
                for p, key, host, view in views:
                    host.copy_(view, non_blocking=True)
                    opt.state[p][key] = host
        finally:
            for g, ps in zip(opt.param_groups, saved):
                g["params"] = ps
        self.adopt()


# --------------------------------------------------------------------------- #
# device-to-host checkpoint staging
# --------------------------------------------------------------------------- #

#: maximum staged snapshots in flight (the double buffer)
MAX_STAGED = 2

#: live (unresolved) snapshots, oldest first — module-global like
#: io_ops._ASYNC_SAVES so ``wait_for_saves`` can drain staging before any
#: synchronous read of the state (the emergency save's ordering)
_INFLIGHT_STAGED: "deque[StagedSnapshot]" = deque()
_STAGED_LOCK = threading.Lock()
_COPY_STREAMS: Dict[Any, Any] = {}


def _signature(leaves: Sequence[Any]) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in leaves
                 if torch.is_tensor(t) and t.device.type == "cuda")


def _alloc_pinned(sig: tuple) -> List[torch.Tensor]:
    return [torch.empty(shape, dtype=dtype, pin_memory=True)
            for shape, dtype in sig]


def _empty_host_cache() -> None:
    """Release torch's cached, unused pinned host blocks (CUDA builds)."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None and torch.cuda.is_available():
        empty()


def _set_nbytes(bufs: Sequence[torch.Tensor]) -> int:
    return sum(b.numel() * b.element_size() for b in bufs)


class PinnedPool:
    """Pinned host buffer sets for staged snapshots, reused across saves
    (``cudaHostAlloc`` of a model's state costs tenths of a second): at
    most :data:`MAX_STAGED` sets for each tree signature. A Stoke owns one
    and closes it when it closes; the sets go with the pool."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: Dict[tuple, List[List[torch.Tensor]]] = {}
        self._made: Dict[tuple, int] = {}
        self._nbytes = 0
        self._closed = False

    @property
    def nbytes(self) -> int:
        """Pinned bytes of the sets the pool holds, free or lent out."""
        return self._nbytes

    def take(self, sig: tuple) -> Tuple[List[torch.Tensor], bool]:
        """A set for a tree of signature ``sig``: a free one, else a new
        one; returns ``(set, pooled)``: whether :meth:`give` takes it back
        (not beyond the bound, nor once the pool is closed)."""
        with self._lock:
            free = self._free.get(sig)
            if free:
                return free.pop(), True
            pooled = (not self._closed
                      and self._made.get(sig, 0) < MAX_STAGED)
            if pooled:
                self._made[sig] = self._made.get(sig, 0) + 1
        bufs = _alloc_pinned(sig)
        if pooled:
            with self._lock:
                self._nbytes += _set_nbytes(bufs)
        return bufs, pooled

    def give(self, sig: tuple, bufs: List[torch.Tensor]) -> None:
        """Return a pooled set; after :meth:`close` it is dropped (to
        torch's pinned host cache, once its snapshot is gone)."""
        with self._lock:
            if self._closed:
                self._nbytes -= _set_nbytes(bufs)
            else:
                self._free.setdefault(sig, []).append(bufs)

    def close(self) -> int:
        """Drop the free sets (the sets lent out are dropped when given
        back) and pool nothing more; returns the bytes dropped now, whose
        page-locked memory goes back to the system (torch's pinned host
        cache would otherwise keep it for the life of the process)."""
        with self._lock:
            self._closed = True
            dropped = sum(_set_nbytes(b) for sets in self._free.values()
                          for b in sets)
            self._free.clear()
            self._nbytes -= dropped
        if dropped:
            _empty_host_cache()
        return dropped


def _copy_stream(device: torch.device):
    s = _COPY_STREAMS.get(device)
    if s is None:
        s = _COPY_STREAMS[device] = torch.cuda.Stream(device=device)
    return s


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy (bfloat16 as its int16 bits, the
    checkpoint's storage type)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


class StagedSnapshot:
    """One tree of tensors mid-flight from the device to the host.

    Construction is the part on the step path: the decoupling copies and
    the asynchronous host copies are issued, then it returns.
    :meth:`resolve` (idempotent, thread-safe) waits for the copies and
    returns ``(treespec, leaves)`` with every tensor leaf as a numpy array
    (views of the pinned buffers until :meth:`release`). The pinned
    buffers come from ``pool`` and go back to it at :meth:`release`;
    without a pool they are allocated for this snapshot alone."""

    def __init__(self, tree: Any, pool: Optional[PinnedPool] = None):
        leaves, self._spec = tree_flatten(tree)
        self._event = None
        self._device_copies: List[torch.Tensor] = []
        self._pinned: List[torch.Tensor] = []
        self._pool = pool
        self._pooled = False
        self._sig = _signature(leaves)
        cuda = [t for t in leaves if torch.is_tensor(t)
                and t.device.type == "cuda"]
        if cuda:
            device = cuda[0].device
            if pool is not None:
                self._pinned, self._pooled = pool.take(self._sig)
            else:
                self._pinned = _alloc_pinned(self._sig)
            # the decoupling copy, on the current stream: the next apply
            # writes the live tensors in place
            self._device_copies = [t.detach().clone() for t in cuda]
            main = torch.cuda.current_stream(device)
            side = _copy_stream(device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for dst, src in zip(self._pinned, self._device_copies):
                    dst.copy_(src, non_blocking=True)
                    # the copy is read on the side stream
                    src.record_stream(side)
                self._event = torch.cuda.Event()
                self._event.record(side)
        pinned = iter(self._pinned)
        self._pending: List[Any] = []
        for leaf in leaves:
            if not torch.is_tensor(leaf):
                self._pending.append(leaf)
            elif leaf.device.type == "cuda":
                self._pending.append(next(pinned))
            else:
                # a host tensor: the copy is synchronous
                self._pending.append(leaf.detach().clone())
        self._lock = threading.Lock()
        self._resolved: Optional[Tuple[Any, List[Any]]] = None
        self._released = False
        with _STAGED_LOCK:
            _INFLIGHT_STAGED.append(self)

    @property
    def resolved(self) -> bool:
        return self._resolved is not None

    @property
    def nbytes(self) -> int:
        """Device bytes of the decoupling copies still held."""
        return sum(t.numel() * t.element_size() for t in self._device_copies)

    def resolve(self) -> Tuple[Any, List[Any]]:
        """Wait for the host copies, drop the device copies and leave the
        in-flight deque; returns ``(treespec, leaves)`` with numpy arrays
        for the tensors. Safe from any thread, any number of times."""
        with self._lock:
            if self._resolved is None:
                if self._event is not None:
                    self._event.synchronize()
                self._device_copies = []
                leaves = [_host_array(x) if torch.is_tensor(x) else x
                          for x in self._pending]
                self._resolved = (self._spec, leaves)
                with _STAGED_LOCK:
                    try:
                        _INFLIGHT_STAGED.remove(self)
                    except ValueError:
                        pass
        return self._resolved

    def release(self) -> None:
        """Give the pinned buffers back to the pool (the arrays
        :meth:`resolve` returned must no longer be read)."""
        self.resolve()
        with self._lock:
            if self._released:
                return
            self._released = True
        if self._pooled and self._pinned:
            self._pool.give(self._sig, self._pinned)
        self._pinned = []
        self._pending = []


def stage_tree(tree: Any, pool: Optional[PinnedPool] = None
               ) -> StagedSnapshot:
    """Stage one tree for a background checkpoint write, its pinned
    buffers from ``pool`` (see :class:`StagedSnapshot`). With
    :data:`MAX_STAGED` snapshots already unresolved, the OLDEST is
    resolved (blocking) first, which bounds the decoupling copies at two
    copies of the state however slow the writer is."""
    while True:
        with _STAGED_LOCK:
            if len(_INFLIGHT_STAGED) < MAX_STAGED:
                break
            oldest = _INFLIGHT_STAGED[0]
        oldest.resolve()
    return StagedSnapshot(tree, pool)


def drain_staged() -> None:
    """Resolve every in-flight staged snapshot (blocking). io_ops
    ``wait_for_saves`` calls this BEFORE joining the writer threads, so an
    emergency save never overlaps a half-landed staging copy."""
    while True:
        with _STAGED_LOCK:
            if not _INFLIGHT_STAGED:
                return
            snap = _INFLIGHT_STAGED[0]
        snap.resolve()


def staged_nbytes() -> int:
    """Device bytes currently held by in-flight staged snapshots (their
    decoupling copies)."""
    with _STAGED_LOCK:
        snaps = list(_INFLIGHT_STAGED)
    return int(sum(s.nbytes for s in snaps))
