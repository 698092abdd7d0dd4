"""Checkpoints: consolidated and sharded saves and loads, sync or async,
on one process or across the processes of a data-parallel run.

Counterpart of ``stoke_tpu/io_ops.py``: the tag scheme
(``checkpoint_tag``, ``_TAG_RE``), ``_writer_rank`` (``:60``, the
``save_rank`` modulo the world), ``save_checkpoint`` (``:299``: barrier,
gather, write, barrier, the metadata by the writer only, last), its async
path, ``wait_for_saves`` (``:604``), ``_prune_old`` (``:648``),
``_latest_tag`` (``:677``) and ``load_checkpoint`` (``:704``: a
consolidated tag loads in a sharded run and the other way round).

A tag is a directory ``stoke-{name}-backward-step-{n}`` that holds:

- one ``.npz`` a state key: ``variables``, ``opt_state``,
  ``scaler_state`` and, saved mid-window, ``grad_buf``, whole leaves by
  name; across processes mid-window also ``grad_local.npz``, each rank's
  own accumulated gradients (``name@rank``), which the mean in
  ``grad_buf`` cannot give back exactly;
- in the sharded format, ``<key>.rank<r>.npz``: rank ``r``'s slices (of
  the optimizer state of the leaves oss, sddp and fsdp shard, of fsdp's
  parameters, of the sharded accumulators) and its own gradients, with
  each sliced leaf's dimension, whole shape, per-rank extents and writers
  in ``meta.json`` (``leaves``); the writer's ``.npz`` holds the rest.
  Under a mesh of several axes ``meta.json`` names the mesh (``mesh``:
  its N axes and shape), a slice that several ranks hold alike is written
  by one of them, and a model split's slices carry their cut (``cut``:
  each level's axes, view and dim, the stride under a stage axis, and
  under a stage cut the model level inside it), so a leaf is put
  together level by level: the cut's innermost level first, then the
  outer ones, then the data dim. A consolidated tag holds the whole
  JAX-layout arrays whatever the mesh. Not
  ``torch.distributed.checkpoint``: the ladder's slices are plain
  tensors, which it would write once, as if every rank held the same;
- ``port.pkl``, the port's own (the dropout generators' states, the
  optimizer's param groups and its non-tensor state), which the JAX
  loader never reads;
- ``extras.pkl`` (the caller's extras), written before
- ``meta.json`` (``format``, ``counters``, ``status``, ``name``; across
  processes or sharded also ``world`` and ``writer``), written last by
  the writer: a tag without it is a partial write and never loads.

The JAX package keys the arrays of an ``.npz`` ``leaf_{i}`` in its tree's
flatten order. The port keys them by name (parameter name, or parameter
name and optimizer state key), so a port tag makes the JAX loader fail
(it finds no ``leaf_0``) rather than load arrays in the wrong order, and
the port's loader checks each array's name, shape and dtype against the
live state, naming the first one that differs. The JAX package's sharded
format (orbax's files) is refused: the port reads it only through a
consolidated save.

An async save copies the state to the host on the calling thread (the
training step changes the device tensors in place afterwards; every
gather and collective stays on that thread) and writes the files on a
background thread; the writer's thread writes ``meta.json`` once every
rank's files exist. With ``CheckpointConfig.offload_staging`` (async,
consolidated) the calling thread only stages the state
(:func:`stoke_tpu_torch.offload.stage_tree`: a device-to-device copy and
asynchronous copies into pinned host buffers) and the background thread
waits for the copies. :func:`wait_for_saves` drains the staged snapshots,
joins the threads and raises any failure, whose partial tag is removed.

Under a ``ResilienceConfig`` every save also writes ``manifest.json``
(:func:`stoke_tpu_torch.resilience.write_manifest`: each file's sha256
and size, with the run's topology descriptor), after ``meta.json``, so a
tag with a manifest is a tag whose write finished. The fault injector's
``on_async_payload`` hook fires in the background writer between the
payload files and ``meta.json``.

With a ``TraceConfig`` the saves and waits are ``stoke/ckpt_save`` and
``stoke/ckpt_wait`` spans on the ``io`` track, and the barriers time into
``sync/barrier_wait_s`` of every live telemetry registry
(:mod:`stoke_tpu_torch.telemetry.fleet`), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_unflatten

from stoke_tpu_torch import offload
from stoke_tpu_torch.configs import CheckpointConfig, CheckpointFormat
from stoke_tpu_torch.resilience import write_manifest
from stoke_tpu_torch.telemetry.fleet import timed_sync
from stoke_tpu_torch.telemetry.tracing import trace_span
from stoke_tpu_torch.utils.printing import make_folder, unrolled_print
from stoke_tpu_torch.utils.trees import to_numpy_tree

_ASYNC_SAVES: list = []  # in-flight background save threads
_ASYNC_ERRORS: list = []  # (tag_dir, exception) of failed background saves
_INFLIGHT_TAGS: set = set()  # tag dirs async saves are writing (never pruned)

#: how long an async save's writer waits for the other ranks' files
_ASYNC_RANK_TIMEOUT_S = 600.0

_TAG_RE = re.compile(r"^stoke-(?P<name>.+)-backward-step-(?P<step>\d+)$")

#: the state keys of a tag, one ``.npz`` each
STATE_KEYS = ("variables", "opt_state", "scaler_state", "grad_buf")
#: the port's own file of a tag
PORT_FILE = "port.pkl"

#: ``(shape, numpy dtype)`` of an array, or None where the live state has
#: no place for it
Spec = Optional[Tuple[tuple, np.dtype]]


def checkpoint_tag(name: str, backward_step: int) -> str:
    """The tag directory's name: ``stoke-{name}-backward-step-{n}``."""
    return f"stoke-{name}-backward-step-{backward_step}"


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor of ``dtype`` is stored as (bfloat16, which
    numpy lacks, as its bits: int16)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty((), dtype=dtype).numpy().dtype


def spec_of(t: torch.Tensor) -> Tuple[tuple, np.dtype]:
    """The ``(shape, numpy dtype)`` a tensor is stored with."""
    return tuple(t.shape), numpy_dtype(t.dtype)


def from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` from an array stored by this module."""
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy(order="C"))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _check_arrays(key: str, arrays: Dict[str, np.ndarray],
                  expect: Callable[[str], Spec],
                  required: Iterable[str]) -> None:
    """Raise ``ValueError`` naming the first name (in sorted order) whose
    array is missing, has no place in the live state, or differs from it
    in shape or dtype."""
    for name in sorted(set(arrays) | set(required)):
        if name not in arrays:
            raise ValueError(
                f"Stoke -- checkpoint {key} has no {name!r}, which the "
                f"current state holds (model/optimizer structure changed?)"
            )
        want = expect(name)
        if want is None:
            raise ValueError(
                f"Stoke -- checkpoint {key} holds {name!r}, which the "
                f"current state has no place for (model/optimizer "
                f"structure changed?)"
            )
        a = arrays[name]
        if (a.shape, a.dtype) != (tuple(want[0]), np.dtype(want[1])):
            raise ValueError(
                f"Stoke -- checkpoint {key} {name!r} is {a.dtype}"
                f"{list(a.shape)}; the current state's is "
                f"{np.dtype(want[1])}{list(want[0])}"
            )


def rank_file(key: str, rank: int) -> str:
    """The sharded format's file of one rank's slices of ``key``."""
    return f"{key}.rank{rank}.npz"


def _leaf_ranks(leaf: Dict[str, Any]) -> list:
    """A sliced leaf's writers: one row a data slice, one rank a part of
    the model split's cut in each row (a tag of one axis names none: rank
    ``d`` wrote slice ``d``)."""
    return leaf.get("ranks") or [[r] for r in range(len(leaf["extents"]))]


def rank_writers(layout: Dict[str, Any], key: str, world: int) -> list:
    """The ranks whose files hold ``key``'s slices in a sharded tag of
    ``layout`` (``meta.json``'s): each sliced leaf's writers, and every
    rank for the ranks' own gradients."""
    ranks = {r for leaf in layout.get("leaves", {}).get(key, {}).values()
             for row in _leaf_ranks(leaf) for r in row}
    if key == "grad_buf" and layout.get("grad_local"):
        ranks.update(range(world))
    return sorted(ranks)


def cut_layout(cut) -> Dict[str, Any]:
    """A model split's :class:`~stoke_tpu_torch.parallel.tensor.Cut` as
    ``meta.json`` records it: this level's axes (``axis``: the first),
    size, whole shape, view and dim, its stride when it is a stage cut
    (rank ``d`` holds ``stages[d::S]``), and the level inside it."""
    out = {"axis": cut.axes[0] if len(cut.axes) == 1 else list(cut.axes),
           "axes": list(cut.axes), "size": cut.size,
           "shape": list(cut.full), "view": list(cut.view), "dim": cut.dim,
           "stride": cut.size if cut.strided else None}
    if cut.inner is not None:
        out["inner"] = cut_layout(cut.inner)
    return out


def _join_cut(cut: Dict[str, Any], parts: list) -> np.ndarray:
    """A cut leaf whole from its slices, by their flattened coordinate
    (the outer level major): each outer block put together from its inner
    level's slices first."""
    inner = cut.get("inner")
    if inner is not None:
        n = len(parts) // cut["size"]
        parts = [_join_cut(inner, parts[k * n:(k + 1) * n])
                 for k in range(cut["size"])]
    view = list(cut["view"])
    view[cut["dim"]] //= len(parts)
    return np.concatenate([p.reshape(view) for p in parts],
                          cut["dim"]).reshape(cut["shape"])


def _join_leaf(leaf: Dict[str, Any], part) -> np.ndarray:
    """A sliced leaf whole from ``part(rank)``, its writers' arrays: each
    row's parts joined by the model split's cut, level by level, then the
    rows concatenated along the data dim."""
    cut = leaf.get("cut")
    rows = []
    for row in _leaf_ranks(leaf):
        parts = [part(r) for r in row]
        rows.append(parts[0] if cut is None else _join_cut(cut, parts))
    if leaf.get("dim") is None:
        return rows[0]
    return np.concatenate(rows, axis=leaf["dim"])


def _barrier(group) -> None:
    # the checkpoint coordination's waits land in sync/barrier_wait_s of
    # every live telemetry registry
    if group is not None and dist.get_world_size(group) > 1:
        with timed_sync("ckpt"):
            dist.barrier(group=group)


def _savez_atomic(path: str, arrays: Dict[str, Any]) -> None:
    """``np.savez`` to a temporary name, then renamed: a rank file that
    exists is complete (the writer's async meta waits on it)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _wait_for_files(paths, timeout_s: float) -> None:
    """Block until every path exists (the other ranks' async rank files),
    or raise ``TimeoutError`` naming the missing ones."""
    deadline = time.monotonic() + timeout_s
    missing = [p for p in paths if not os.path.exists(p)]
    while missing:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"Stoke -- the other ranks' checkpoint files did not land "
                f"within {timeout_s:.0f} s: {missing}")
        time.sleep(0.01)
        missing = [p for p in missing if not os.path.exists(p)]


def save_checkpoint(
    path: str,
    name: str,
    state: Dict[str, Dict[str, Any]],
    counters: Dict[str, int],
    status: Dict[str, Any],
    extras: Optional[Dict[str, Any]],
    config: CheckpointConfig,
    backward_step: int,
    port_state: Optional[Dict[str, Any]] = None,
    rank_state: Optional[Dict[str, Dict[str, Any]]] = None,
    layout: Optional[Dict[str, Any]] = None,
    group=None,
    manifest: bool = False,
    topology: Optional[Dict[str, Any]] = None,
    chaos: Any = None,
    on_durable: Optional[Callable[[], None]] = None,
    staging_pool: Any = None,
) -> str:
    """Write one checkpoint; returns the tag directory's path.

    ``state`` maps a state key (:data:`STATE_KEYS`, or ``grad_local``) to
    the arrays the writer writes, by name (tensors on any device, or numpy
    arrays): every array in the consolidated format, the replicated ones
    in the sharded format. ``rank_state`` holds this rank's slices in the
    sharded format, written by every rank as :func:`rank_file`, and
    ``layout`` (``world`` and the sharded leaves) goes into ``meta.json``.
    ``counters`` are the three JAX counters (``backward_step``,
    ``grad_accum_step``, ``optimizer_step``), ``status`` the status dict,
    ``port_state`` goes to ``port.pkl``.

    Across the processes of ``group`` (the JAX flow, ``:299``): the
    writer (``save_rank`` modulo the world) makes the tag directory, all
    pass a barrier, every rank writes its rank files and the writer the
    rest, ``meta.json`` last and by the writer only, then a barrier. The
    gathers that build ``state`` are the caller's, on the calling thread.
    With ``config.async_save`` the arrays are copied to the host here and
    written on a background thread (see :func:`wait_for_saves`); the
    writer's thread writes ``meta.json`` once every rank file exists.
    Then the tags of ``name`` beyond ``config.max_to_keep`` are
    pruned.

    ``config.offload_staging`` (async, consolidated): the writer's arrays
    are staged (:func:`stoke_tpu_torch.offload.stage_tree`, its pinned
    buffers from ``staging_pool``) instead of copied to the host here.
    ``manifest``: the writer adds ``manifest.json`` after ``meta.json``,
    with ``topology`` (the run's descriptor) in it. ``chaos``: the run's ``ChaosInjector``, whose
    ``on_async_payload`` fires between an async save's payload and its
    ``meta.json``. ``on_durable``: called once this save has landed (on
    return of a sync save, from the background thread after ``meta.json``
    for an async one)."""
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    writer = int(config.save_rank) % world
    is_writer = rank == writer
    root = make_folder(path) if is_writer else os.path.abspath(
        os.path.expanduser(path))
    tag = checkpoint_tag(name, backward_step)
    tag_dir = os.path.join(root, tag)
    is_async = bool(config.async_save)
    sharded = config.format is CheckpointFormat.sharded
    staged = is_async and not sharded and bool(config.offload_staging)
    snap = None
    if is_async:
        # claimed before the directory exists: an earlier save's prune
        # must never take this (still meta-less) tag for a leftover
        _INFLIGHT_TAGS.add(tag_dir)
    try:
        if is_writer:
            os.makedirs(tag_dir, exist_ok=True)
        _barrier(group)
        # the host copy, on this thread: training changes the device
        # tensors in place once this returns (traced as the async save's
        # cost on the step path; the write is off it by design)
        with (trace_span("stoke/ckpt_save", track="io",
                         attrs={"tag": tag, "async": True,
                                "staged": staged})
              if is_async else contextlib.nullcontext()):
            if staged:
                # one snapshot a save, so staging never waits on its own
                # earlier trees
                host = {}
                if is_writer:
                    snap = offload.stage_tree(
                        {k: v for k, v in state.items() if v is not None},
                        pool=staging_pool)
            else:
                host = ({k: to_numpy_tree(v) for k, v in state.items()
                         if v is not None} if is_writer else {})
            mine = {k: to_numpy_tree(v)
                    for k, v in (rank_state or {}).items()
                    if v is not None} if sharded else {}
    except BaseException:
        _INFLIGHT_TAGS.discard(tag_dir)
        raise
    rank_files = ([os.path.join(tag_dir, rank_file(k, r))
                   for k in STATE_KEYS
                   for r in rank_writers(layout or {}, k, world)]
                  if sharded else [])

    def write_payload() -> None:
        if snap is not None:
            spec, leaves = snap.resolve()
            host.update(tree_unflatten(leaves, spec))
        for key, arrays in mine.items():
            _savez_atomic(os.path.join(tag_dir, rank_file(key, rank)), arrays)
        for key, arrays in host.items():
            np.savez(os.path.join(tag_dir, f"{key}.npz"), **arrays)
        if port_state is not None and is_writer:
            with open(os.path.join(tag_dir, PORT_FILE), "wb") as f:
                pickle.dump(port_state, f)

    def write_meta() -> None:
        if not is_writer:
            return
        # extras before meta.json: meta is the "loadable" marker, so a
        # kill between the two leaves the tag unloadable, never loaded
        # without its extras
        if extras:
            with open(os.path.join(tag_dir, "extras.pkl"), "wb") as f:
                pickle.dump(extras, f)
        meta = {"format": config.format.value, "counters": counters,
                "status": status, "name": name}
        if sharded or world > 1:
            # the one-process consolidated meta stays the JAX package's
            meta.update(world=world, writer=writer, **(layout or {}))
        with open(os.path.join(tag_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        if manifest:
            extra = {"backward_step": backward_step, "name": name}
            if topology is not None:
                extra["topology"] = topology
            write_manifest(tag_dir, extra=extra)

    def landed() -> None:
        if on_durable is not None:
            try:
                on_durable()
            except Exception:
                pass  # accounting must never fail a landed save

    if not is_async:
        # the synchronous write path end to end: payload, metadata, barrier
        with trace_span("stoke/ckpt_save", track="io", attrs={"tag": tag}):
            write_payload()
            _barrier(group)
            write_meta()
            if is_writer:
                _prune_old(root, name, config.max_to_keep)
                unrolled_print(f"Saved checkpoint {tag_dir}")
            _barrier(group)
        landed()
        return tag_dir

    def background() -> None:
        try:
            write_payload()
            if snap is not None:
                snap.release()
            if is_writer:
                # every rank's slices on disk before the loadable marker
                _wait_for_files(rank_files, _ASYNC_RANK_TIMEOUT_S)
            if chaos is not None:
                # kill_during_save: the payload is on disk, meta.json not
                chaos.on_async_payload(tag_dir)
            write_meta()
            # loadable now: out of the in-flight set before pruning, so it
            # counts toward its own keep window
            _INFLIGHT_TAGS.discard(tag_dir)
            landed()
            if is_writer:
                _prune_old(root, name, config.max_to_keep)
                unrolled_print(f"Saved checkpoint {tag_dir} (async)")
        except BaseException as e:  # raised by wait_for_saves()
            # a failure before meta.json leaves a tag that can never load:
            # the writer removes it; one after (in the prune) keeps the
            # complete tag
            if is_writer and not os.path.exists(
                    os.path.join(tag_dir, "meta.json")):
                shutil.rmtree(tag_dir, ignore_errors=True)
            _ASYNC_ERRORS.append((tag_dir, e))
        finally:
            _INFLIGHT_TAGS.discard(tag_dir)
            if snap is not None:
                snap.release()

    t = threading.Thread(target=background, name=f"stoke-save-{tag}",
                         daemon=False)
    _ASYNC_SAVES.append(t)
    try:
        t.start()
    except BaseException:
        _ASYNC_SAVES.remove(t)
        _INFLIGHT_TAGS.discard(tag_dir)
        raise
    return tag_dir


def wait_for_saves() -> None:
    """Block until every in-flight async save has finished, then raise
    ``RuntimeError`` naming every tag whose save failed (the first
    failure chained as the cause); the failures are cleared, so a later
    call returns cleanly. The staged snapshots are drained first, so a
    synchronous read of the state that follows (the emergency save's)
    never overlaps a half-landed staging copy."""
    with trace_span("stoke/ckpt_wait", track="io"):
        offload.drain_staged()
        while _ASYNC_SAVES:
            _ASYNC_SAVES.pop().join()
    if _ASYNC_ERRORS:
        failures = list(_ASYNC_ERRORS)
        _ASYNC_ERRORS.clear()
        detail = "; ".join(f"{tag_dir} ({type(err).__name__}: {err})"
                           for tag_dir, err in failures)
        raise RuntimeError(
            f"Stoke -- {len(failures)} async checkpoint save"
            f"{'s' if len(failures) > 1 else ''} failed: {detail}"
        ) from failures[0][1]


def _prune_old(root: str, name: str, max_to_keep: Optional[int]) -> None:
    """Keep the newest ``max_to_keep`` loadable tags of ``name`` (by
    backward step). Tags in flight are never touched; meta-less tags not
    in flight are leftovers of a failed save and are removed, and never
    count toward the keep window."""
    if not max_to_keep:
        return
    tags, stale = [], []
    for entry in os.listdir(root):
        m = _TAG_RE.match(entry)
        if not m or m.group("name") != name:
            continue
        if os.path.join(root, entry) in _INFLIGHT_TAGS:
            continue
        if not os.path.exists(os.path.join(root, entry, "meta.json")):
            stale.append(entry)
            continue
        tags.append((int(m.group("step")), entry))
    tags.sort()
    for entry in stale:
        shutil.rmtree(os.path.join(root, entry), ignore_errors=True)
    for _, entry in tags[:-max_to_keep]:
        shutil.rmtree(os.path.join(root, entry), ignore_errors=True)


def _latest_tag(root: str, name: Optional[str]) -> Optional[str]:
    """The newest loadable tag (one with its ``meta.json``) by backward
    step, of ``name`` when given (two runs sharing a directory never load
    each other's state)."""
    best = None
    for entry in os.listdir(root):
        m = _TAG_RE.match(entry)
        if (m and (name is None or m.group("name") == name)
                and os.path.exists(os.path.join(root, entry, "meta.json"))):
            step = int(m.group("step"))
            if best is None or step > best[0]:
                best = (step, entry)
    return best[1] if best else None


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {name: data[name] for name in data.files}


def _read_key(tag_dir: str, key: str, meta: Dict[str, Any]
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, list]]:
    """``key``'s arrays by name, whole: the writer's ``.npz`` and, in the
    sharded format, each sharded leaf put together from the ranks' files
    along its dimension. Also returns the ranks' local partial gradients
    (``grad_buf`` saved mid-window across processes), one array a rank,
    by name."""
    arrays: Dict[str, np.ndarray] = {}
    whole = os.path.join(tag_dir, f"{key}.npz")
    if os.path.exists(whole):
        arrays.update(_read_npz(whole))
    local: Dict[str, list] = {}
    if key == "grad_buf" and os.path.exists(
            os.path.join(tag_dir, "grad_local.npz")):
        for label, a in sorted(_read_npz(
                os.path.join(tag_dir, "grad_local.npz")).items(),
                key=lambda kv: int(kv[0].rpartition("@")[2])):
            local.setdefault(label.rpartition("@")[0], []).append(a)
    sliced = meta.get("leaves", {}).get(key, {})
    local_names = meta.get("grad_local", []) if key == "grad_buf" else []
    if meta.get("format") == CheckpointFormat.sharded.value and (
            sliced or local_names):
        world = int(meta["world"])
        ranks = {r: _read_npz(os.path.join(tag_dir, rank_file(key, r)))
                 for r in rank_writers(meta, key, world)}
        for n, leaf in sliced.items():
            arrays[n] = _join_leaf(leaf, lambda r: ranks[r][n])
        for n in local_names:
            local[n] = [ranks[r][n] for r in range(world)]
    for n, parts in local.items():
        if n not in arrays:
            total = parts[0].astype(np.float32)
            for a in parts[1:]:
                total = total + a
            arrays[n] = (total / np.float32(len(parts))).astype(parts[0].dtype)
    return arrays, local


def load_checkpoint(
    path: str,
    tag: Optional[str],
    expect: Dict[str, Tuple[Callable[[str], Spec], Iterable[str]]],
    name: Optional[str] = None,
) -> Dict[str, Any]:
    """Read a checkpoint into host arrays, whole, whatever format and
    world wrote it (a consolidated tag loads in a sharded run and the
    other way round, at any world size, as the JAX loader promises).

    ``tag=None`` reads the newest loadable tag under ``path`` (of
    ``name`` when given); ``FileNotFoundError`` when there is none.
    ``expect`` maps each state key to ``(spec, required)``: ``spec(name)``
    is the live state's ``(shape, numpy dtype)`` for an array name (whole
    leaves), or None where it has no place for it, and ``required`` the
    names the tag must hold. A tag without accumulated gradients gives
    ``grad_buf`` None; one saved mid-window across processes gives the
    global batch's gradients (the mean of the ranks') in ``grad_buf`` and
    each rank's own in ``grad_local`` (name -> one array a rank). Returns
    the arrays by state key, with ``counters``, ``status``, ``world``,
    ``extras`` and ``port`` (``port.pkl``, or an empty dict). A sharded
    tag of the JAX package (orbax's format) raises ``ValueError``."""
    root = os.path.abspath(os.path.expanduser(path))
    if tag is None:
        tag = _latest_tag(root, name) if os.path.isdir(root) else None
        if tag is None:
            raise FileNotFoundError(
                f"Stoke -- no checkpoints found under {root}")
    tag_dir = os.path.join(root, tag)
    with open(os.path.join(tag_dir, "meta.json")) as f:
        meta = json.load(f)
    fmt = CheckpointFormat(meta["format"])
    if fmt is CheckpointFormat.sharded and "world" not in meta:
        raise ValueError(
            f"Stoke -- {tag_dir} is the JAX package's sharded checkpoint "
            f"format (orbax's tensorstore files), which the port cannot "
            f"read without orbax; save it with CheckpointConfig("
            f"format='consolidated') to resume it here")
    payload: Dict[str, Any] = {"counters": meta["counters"],
                               "status": meta["status"], "grad_buf": None,
                               "grad_local": None,
                               "world": int(meta.get("world", 1))}
    for key in STATE_KEYS:
        present = any(os.path.exists(os.path.join(tag_dir, f))
                      for f in (f"{key}.npz", rank_file(key, 0)))
        if key == "grad_buf" and not present:
            continue
        arrays, local = _read_key(tag_dir, key, meta)
        spec, required = expect[key]
        _check_arrays(key, arrays, spec, required)
        payload[key] = arrays
        if local:
            payload["grad_local"] = local
    payload["port"] = {}
    port_path = os.path.join(tag_dir, PORT_FILE)
    if os.path.exists(port_path):
        with open(port_path, "rb") as f:
            payload["port"] = pickle.load(f)
    payload["extras"] = {}
    extras_path = os.path.join(tag_dir, "extras.pkl")
    if os.path.exists(extras_path):
        with open(extras_path, "rb") as f:
            payload["extras"] = pickle.load(f)
    unrolled_print(f"Loaded checkpoint {tag_dir}")
    return payload
