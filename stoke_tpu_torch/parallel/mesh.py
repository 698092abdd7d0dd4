"""Process groups and the device mesh of the port.

Counterpart of ``stoke_tpu/parallel/mesh.py``: the rendezvous is
``torch.distributed.init_process_group`` (NCCL for the card, gloo for the
CPU; nothing else is substituted) and the mesh a ``DeviceMesh``: the 1-D
data axis, or the data axis and one more: ``("data", "seq")`` of sequence
parallelism, whose ``seq`` sub-groups run the ring and Ulysses
collectives (:mod:`stoke_tpu_torch.ops.attention`), or ``("data", X)``
for the model or expert axis X that partition rules name, whose
sub-groups run the Megatron and expert splits
(:mod:`stoke_tpu_torch.parallel.tensor`) while the ladder reduces over
the data sub-groups (:func:`data_coordinates`). Meshes of three or more
axes and cross-host axes are ROADMAP Queue 1 item 8e.

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

_LATER_MESH = ("ROADMAP Queue 1 item 8e (meshes of three axes, dcn_axes "
               "and partition rules beyond the Megatron, expert and stage "
               "sets)")

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
    """The ``DeviceMesh`` over the process group's ranks: the 1-D mesh
    ``data_axis``, or a two-axis mesh of ``data_axis`` and one more (a
    sequence, model, expert or stage axis, in either order; the last axis
    varies fastest over the ranks). A 1-D mesh of another axis is the
    ``(1, n)`` mesh of ``data_axis`` and it: every process takes the same
    rows, as the JAX package replicates the batch over a mesh without its
    data axis. ``shape`` may be None, or name each axis's size with one
    ``-1`` inferred; its errors are the JAX package's. Meshes of three or
    more axes, two axes without the data axis and cross-host axes are
    refused (ROADMAP item 8e), and an explicit device list: under the
    port each process brings its one device."""
    from torch.distributed.device_mesh import init_device_mesh

    axes = tuple(mesh_config.axes)
    if (len(axes) > 2 or mesh_config.dcn_axes
            or (len(axes) == 2 and data_axis not in axes)):
        raise NotImplementedError(
            f"Stoke -- a mesh of axes {axes} (dcn_axes "
            f"{tuple(mesh_config.dcn_axes)}) is not ported yet: the port's "
            f"mesh is the data axis {data_axis!r}, or it and one more; "
            f"{_LATER_MESH}")
    if mesh_config.devices is not None:
        raise ValueError(
            "Stoke -- MeshConfig.devices has no meaning in the port: each "
            "process drives one device (launch one process a device)")
    shape = mesh_shape(mesh_config.shape, dist.get_world_size(), len(axes))
    if len(axes) == 1 and axes[0] != data_axis:
        axes, shape = (data_axis, axes[0]), (1, *shape)
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def data_coordinates(mesh, data_axis: str = "data") -> tuple:
    """``(data sub-group, its size, this process's coordinate on it)`` of
    a two-axis mesh (a ``seq``, model, expert or stage axis beside the
    data axis): the processes that share this one's place on the other
    axis."""
    group = mesh.get_group(data_axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def other_coordinates(mesh, data_axis: str = "data") -> tuple:
    """``(sub-group, its size, this process's coordinate on it)`` of a
    two-axis mesh's other axis: the processes that share this one's data
    coordinate (the shards of one data row under ``seq``, one model,
    expert or stage group otherwise)."""
    axis = next(a for a in mesh.mesh_dim_names if a != data_axis)
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)
