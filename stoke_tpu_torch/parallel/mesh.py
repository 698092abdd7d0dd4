"""Process groups and the device mesh of the port.

Counterpart of ``stoke_tpu/parallel/mesh.py``: the rendezvous is
``torch.distributed.init_process_group`` (NCCL for the card, gloo for the
CPU; nothing else is substituted) and the mesh a ``DeviceMesh`` of any
number of named axes: the data axis, and beside it a ``seq`` axis of
sequence parallelism, whose sub-groups run the ring and Ulysses
collectives (:mod:`stoke_tpu_torch.ops.attention`), and model, expert or
stage axes that partition rules name, whose sub-groups run the Megatron,
expert and stage splits (:mod:`stoke_tpu_torch.parallel.tensor`), while
the ladder reduces over the data sub-groups. :func:`axis_coordinates`
gives any axis's sub-group, or the flattened sub-group of several axes.

**One process, one device.** In the JAX package one process drives every
device of its host. Under the port each process drives exactly one:
``cuda:LOCAL_RANK`` (or the CPU), so a run of W devices is W processes,
launched by ``torchrun --nproc-per-node W`` or spawned, and the world
size is the number of processes. The JAX package's
``local_device_count`` has no counterpart: here it would always be 1.

A run with ``distributed="dp"`` but neither a process group nor
torchrun's variables makes a one-process group over a ``FileStore`` in a
temporary directory (:func:`one_process_group`): world 1, the same code
path and collectives as a run of W.
"""

from __future__ import annotations

import math
import os
import tempfile
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from stoke_tpu_torch.configs import DistributedInitConfig, MeshConfig

#: the directory of the newest one-process group's store (removed when
#: a later group replaces it, or at exit)
_ONE_PROCESS_DIR: Optional[tempfile.TemporaryDirectory] = None


def _multihost_env_present() -> bool:
    """Whether a launcher (torchrun, or anything that sets its variables)
    started this process as one rank of several: ``RANK``, ``WORLD_SIZE``
    and ``MASTER_ADDR`` set, the world larger than one."""
    if not all(os.environ.get(v) for v in ("RANK", "WORLD_SIZE",
                                            "MASTER_ADDR")):
        return False
    try:
        return int(os.environ["WORLD_SIZE"]) > 1
    except ValueError:
        return False


def backend_for(device: torch.device) -> str:
    """The collective backend of a device: NCCL for the card (raises when
    this torch has none; gloo cannot reduce-scatter CUDA tensors, so it is
    never put in its place), gloo for the CPU."""
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError(
                "Stoke -- distributed runs on the card need the NCCL "
                "backend, and this torch has none")
        return "nccl"
    return "gloo"


def local_rank(cfg: Optional[DistributedInitConfig] = None) -> int:
    """The index of this process's device on its host:
    ``DistributedInitConfig.local_device_ids`` (one id) when given, else
    ``LOCAL_RANK``, else 0."""
    ids = None if cfg is None else cfg.local_device_ids
    if ids is not None:
        ids = list(ids)
        if len(ids) != 1:
            raise ValueError(
                f"Stoke -- a process of the port drives one device; "
                f"local_device_ids={ids} names {len(ids)}")
        return int(ids[0])
    return int(os.environ.get("LOCAL_RANK", "0"))


def _check_backend(device: torch.device) -> None:
    got = dist.get_backend()
    want = backend_for(device)
    if want not in str(got):
        raise RuntimeError(
            f"Stoke -- the process group runs {got!r}, and a run on "
            f"{device.type} needs {want!r}")


def initialize_distributed(cfg: DistributedInitConfig,
                           device: torch.device) -> bool:
    """Join the run's process group, once: the JAX ``initialize_distributed``
    with ``torch.distributed``.

    - a group already initialised (by the launcher or an earlier
      ``Stoke``) is used as it is, if its backend fits ``device``;
    - explicit ``coordinator_address`` / ``num_processes`` /
      ``process_id`` rendezvous at ``tcp://coordinator_address``;
    - else torchrun's variables (``env://``);
    - else no group: returns False (the caller makes a one-process group).

    Returns whether a group exists afterwards."""
    explicit = (cfg.num_processes is not None
                or cfg.coordinator_address is not None)
    if explicit and (cfg.num_processes is None or cfg.process_id is None
                     or cfg.coordinator_address is None):
        raise ValueError(
            "Stoke -- an explicit rendezvous needs coordinator_address, "
            "num_processes and process_id")
    if dist.is_initialized():
        _check_backend(device)
        return True
    kw = dict(backend=backend_for(device),
              timeout=timedelta(seconds=cfg.initialization_timeout))
    if device.type == "cuda":
        kw["device_id"] = device
    if explicit:
        addr = cfg.coordinator_address
        dist.init_process_group(
            init_method=addr if "://" in addr else f"tcp://{addr}",
            world_size=cfg.num_processes, rank=cfg.process_id, **kw)
        return True
    if _multihost_env_present():
        dist.init_process_group(init_method="env://", **kw)
        return True
    return False


def one_process_group(device: torch.device) -> None:
    """A process group of this process alone (world 1) over a
    ``FileStore`` in a temporary directory, which is removed when the
    interpreter exits."""
    global _ONE_PROCESS_DIR
    _ONE_PROCESS_DIR = tempfile.TemporaryDirectory(prefix="stoke-pg-")
    store = dist.FileStore(os.path.join(_ONE_PROCESS_DIR.name, "store"), 1)
    kw = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group(backend_for(device), store=store, rank=0,
                            world_size=1, **kw)


def mesh_shape(shape: Optional[tuple], n: int, n_axes: int = 1) -> tuple:
    """The mesh's shape over ``n`` devices: ``shape``, with one ``-1``
    inferred, or ``(n, 1, ...)`` of ``n_axes`` for None; the JAX package's
    errors where it cannot be."""
    shape = (n,) + (1,) * (n_axes - 1) if shape is None else tuple(shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        if n % known != 0:
            raise ValueError(
                f"Stoke -- cannot infer mesh shape {shape} from {n} devices")
        shape = tuple(n // known if s == -1 else s for s in shape)
    if math.prod(shape) != n:
        raise ValueError(
            f"Stoke -- mesh shape {shape} does not match {n} devices")
    return shape


def build_mesh(mesh_config: MeshConfig, device: torch.device,
               data_axis: str = "data"):
    """The ``DeviceMesh`` over the process group's ranks, of the config's
    axes in their order (the last axis varies fastest over the ranks).
    A mesh without ``data_axis`` gets a data axis of 1 in front: every
    process takes the same rows, as the JAX package replicates the batch
    over a mesh without its data axis. ``shape`` may be None, or name
    each axis's size with one ``-1`` inferred; its errors are the JAX
    package's. An explicit device list is refused: under the port each
    process brings its one device.

    ``dcn_axes`` is accepted and has no effect, as in the JAX package,
    where no module reads it: the launcher orders the ranks (hosts
    outermost under ``torchrun``), and NCCL picks each pair's transport
    (NVLink within a host, the network across hosts)."""
    from torch.distributed.device_mesh import init_device_mesh

    axes = tuple(mesh_config.axes)
    if mesh_config.devices is not None:
        raise ValueError(
            "Stoke -- MeshConfig.devices has no meaning in the port: each "
            "process drives one device (launch one process a device)")
    shape = mesh_shape(mesh_config.shape, dist.get_world_size(), len(axes))
    if data_axis not in axes:
        axes, shape = (data_axis, *axes), (1, *shape)
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def _flat_rows(mesh, axes: tuple) -> list:
    """The world ranks of each flattened sub-group of ``axes``, by
    flattened coordinate (the first axis major)."""
    names = list(mesh.mesh_dim_names)
    inner = [names.index(a) for a in axes]
    outer = [d for d in range(len(names)) if d not in inner]
    return mesh.mesh.permute(*outer, *inner).reshape(
        -1, math.prod(mesh.mesh.shape[d] for d in inner)).tolist()


def _flat_row(mesh, axes: tuple) -> list:
    """The world ranks of this process's flattened sub-group of
    ``axes``."""
    me = dist.get_rank()
    return next(row for row in _flat_rows(mesh, axes) if me in row)


def axis_coordinates(mesh, axis) -> tuple:
    """``(sub-group, its size, this process's coordinate on it)`` of the
    mesh axis ``axis``: the processes that share this one's coordinates
    on every other axis (the ladder's data sub-group, the shards of one
    data row under ``seq``, one model, expert or stage group). A tuple of
    several axes is their flattened sub-group, the coordinate the first
    axis major (the JAX order of a dim placed on a tuple of axes); it is
    made once a mesh, collectively: every process asks for the same
    tuples in the same order. Where the tuple's order is not the mesh's,
    the group's ranks (by world rank) are not the coordinates:
    :func:`axis_order` maps one to the other."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
        return group, dist.get_world_size(group), dist.get_rank(group)
    made = mesh.__dict__.setdefault("_stoke_flat", {})
    if axes not in made:
        made[axes] = dist.new_subgroups_by_enumeration(
            _flat_rows(mesh, axes))[0]
    group = made[axes]
    return (group, dist.get_world_size(group),
            _flat_row(mesh, axes).index(dist.get_rank()))


def axis_order(mesh, axes) -> Optional[tuple]:
    """For the flattened sub-group of ``axes``: the group rank of each
    flattened coordinate, or None where they are the same (one axis, or
    axes in the mesh's order). A process group numbers its members by
    world rank, so a collective over it lays out the members' parts in
    that order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    row = _flat_row(mesh, axes)
    order = tuple(sorted(row).index(r) for r in row)
    return None if order == tuple(range(len(row))) else order
