"""Checkpoints on one process: consolidated save and load, sync or async.

Counterpart of ``stoke_tpu/io_ops.py`` for one process: the tag scheme
(``checkpoint_tag``, ``_TAG_RE``), the consolidated layout (``:84-123``),
``save_checkpoint`` (``:299``) with its async path, ``wait_for_saves``
(``:604``), ``_prune_old`` (``:648``), ``_latest_tag`` (``:677``) and
``load_checkpoint`` (``:704``). The sharded format and multi-process
gathers wait for ROADMAP Queue 1 item 6b; the status layer refuses them.

A tag is a directory ``stoke-{name}-backward-step-{n}`` that holds:

- one ``.npz`` a state key: ``variables``, ``opt_state``,
  ``scaler_state`` and, saved mid-window, ``grad_buf``;
- ``port.pkl``, the port's own (the dropout generator's state, the
  optimizer's param groups and its non-tensor state), which the JAX
  loader never reads;
- ``extras.pkl`` (the caller's extras), written before
- ``meta.json`` (``format``, ``counters``, ``status``, ``name``), written
  last: a tag without it is a partial write and never loads.

The JAX package keys the arrays of an ``.npz`` ``leaf_{i}`` in its tree's
flatten order. The port keys them by name (parameter name, or parameter
name and optimizer state key), so a port tag makes the JAX loader fail
(it finds no ``leaf_0``) rather than load arrays in the wrong order, and
the port's loader checks each array's name, shape and dtype against the
live state, naming the first one that differs.

An async save copies the state to the host on the calling thread (the
training step changes the device tensors in place afterwards) and writes
the files on a background thread; :func:`wait_for_saves` joins the
threads and raises any failure, whose partial tag is removed.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import threading
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from stoke_tpu_torch.configs import CheckpointConfig, CheckpointFormat
from stoke_tpu_torch.utils.printing import make_folder, unrolled_print
from stoke_tpu_torch.utils.trees import to_numpy_tree

_ASYNC_SAVES: list = []  # in-flight background save threads
_ASYNC_ERRORS: list = []  # (tag_dir, exception) of failed background saves
_INFLIGHT_TAGS: set = set()  # tag dirs async saves are writing (never pruned)

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


def _load_consolidated(tag_dir: str, key: str, expect: Callable[[str], Spec],
                       required: Iterable[str] = ()) -> Dict[str, np.ndarray]:
    """The arrays of ``key``'s ``.npz`` by name, each checked against the
    live state (:func:`_check_arrays`)."""
    with np.load(os.path.join(tag_dir, f"{key}.npz"),
                 allow_pickle=False) as data:
        arrays = {name: data[name] for name in data.files}
    _check_arrays(key, arrays, expect, required)
    return arrays


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
) -> str:
    """Write one checkpoint; returns the tag directory's path.

    ``state`` maps a state key (:data:`STATE_KEYS`) to its arrays by name
    (tensors on any device, or numpy arrays). ``counters`` are the three
    JAX counters (``backward_step``, ``grad_accum_step``,
    ``optimizer_step``), ``status`` the status dict. ``port_state`` goes
    to ``port.pkl``. With ``config.async_save`` the state is copied to the
    host here and written on a background thread (see
    :func:`wait_for_saves`); otherwise everything is written before this
    returns. Either way ``meta.json`` is written last and then the tags
    of ``name`` beyond ``config.max_to_keep`` are pruned."""
    if config.format is not CheckpointFormat.consolidated:
        raise NotImplementedError(
            "Stoke -- the sharded checkpoint format is not ported yet: "
            "ROADMAP Queue 1 item 6b"
        )
    root = make_folder(path)
    tag = checkpoint_tag(name, backward_step)
    tag_dir = os.path.join(root, tag)
    is_async = bool(config.async_save)
    if is_async:
        # claimed before the directory exists: an earlier save's prune
        # must never take this (still meta-less) tag for a leftover
        _INFLIGHT_TAGS.add(tag_dir)
    try:
        os.makedirs(tag_dir, exist_ok=True)
        # the host copy, on this thread: training changes the device
        # tensors in place once this returns
        host = {k: to_numpy_tree(v) for k, v in state.items()
                if v is not None}
    except BaseException:
        _INFLIGHT_TAGS.discard(tag_dir)
        raise

    def write_payload() -> None:
        for key, arrays in host.items():
            np.savez(os.path.join(tag_dir, f"{key}.npz"), **arrays)
        if port_state is not None:
            with open(os.path.join(tag_dir, PORT_FILE), "wb") as f:
                pickle.dump(port_state, f)

    def write_meta() -> None:
        # extras before meta.json: meta is the "loadable" marker, so a
        # kill between the two leaves the tag unloadable, never loaded
        # without its extras
        if extras:
            with open(os.path.join(tag_dir, "extras.pkl"), "wb") as f:
                pickle.dump(extras, f)
        meta = {"format": config.format.value, "counters": counters,
                "status": status, "name": name}
        with open(os.path.join(tag_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)

    if not is_async:
        write_payload()
        write_meta()
        _prune_old(root, name, config.max_to_keep)
        unrolled_print(f"Saved checkpoint {tag_dir}")
        return tag_dir

    def background() -> None:
        try:
            write_payload()
            write_meta()
            # loadable now: out of the in-flight set before pruning, so it
            # counts toward its own keep window
            _INFLIGHT_TAGS.discard(tag_dir)
            _prune_old(root, name, config.max_to_keep)
            unrolled_print(f"Saved checkpoint {tag_dir} (async)")
        except BaseException as e:  # raised by wait_for_saves()
            # a failure before meta.json leaves a tag that can never load:
            # remove it; one after (in the prune) keeps the complete tag
            if not os.path.exists(os.path.join(tag_dir, "meta.json")):
                shutil.rmtree(tag_dir, ignore_errors=True)
            _ASYNC_ERRORS.append((tag_dir, e))
        finally:
            _INFLIGHT_TAGS.discard(tag_dir)

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
    call returns cleanly."""
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
    """The newest tag by backward step, of ``name`` when given (two runs
    sharing a directory never load each other's state)."""
    best = None
    for entry in os.listdir(root):
        m = _TAG_RE.match(entry)
        if m and (name is None or m.group("name") == name):
            step = int(m.group("step"))
            if best is None or step > best[0]:
                best = (step, entry)
    return best[1] if best else None


def load_checkpoint(
    path: str,
    tag: Optional[str],
    expect: Dict[str, Tuple[Callable[[str], Spec], Iterable[str]]],
    name: Optional[str] = None,
) -> Dict[str, Any]:
    """Read a checkpoint into host arrays.

    ``tag=None`` reads the newest tag under ``path`` (of ``name`` when
    given); ``FileNotFoundError`` when there is none. ``expect`` maps each
    state key to ``(spec, required)``: ``spec(name)`` is the live state's
    ``(shape, numpy dtype)`` for an array name, or None where it has no
    place for it, and ``required`` the names the tag must hold. A tag
    without ``grad_buf.npz`` gives ``grad_buf`` None. Returns the arrays
    by state key, with ``counters``, ``status``, ``extras`` and ``port``
    (``port.pkl``, or an empty dict)."""
    root = os.path.abspath(os.path.expanduser(path))
    if tag is None:
        tag = _latest_tag(root, name) if os.path.isdir(root) else None
        if tag is None:
            raise FileNotFoundError(
                f"Stoke -- no checkpoints found under {root}")
    tag_dir = os.path.join(root, tag)
    with open(os.path.join(tag_dir, "meta.json")) as f:
        meta = json.load(f)
    if CheckpointFormat(meta["format"]) is not CheckpointFormat.consolidated:
        raise NotImplementedError(
            "Stoke -- loading the sharded checkpoint format is not ported "
            "yet: ROADMAP Queue 1 item 6b"
        )
    payload: Dict[str, Any] = {"counters": meta["counters"],
                               "status": meta["status"], "grad_buf": None}
    for key in STATE_KEYS:
        present = os.path.exists(os.path.join(tag_dir, f"{key}.npz"))
        if key == "grad_buf" and not present:
            continue
        spec, required = expect[key]
        payload[key] = _load_consolidated(tag_dir, key, spec, required)
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
