"""The device mesh of the PyTorch port (its counterpart of the JAX package's
``parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh``; the port
runs one process per rank over ``torch.distributed``, and its mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with dims ``("data",
"model")``. ``model`` varies fastest: rank ``r`` sits at ``(r // model, r %
model)``, as JAX's ``np.asarray(devices).reshape(data, model)`` places
device ``r``. The process group must be initialised first, with exactly
``data * model`` ranks (``torch.distributed.init_process_group``, or
:func:`.launch.run_ranks`); nothing builds a one-rank mesh on its own.

The backend is the caller's choice when the group is initialised: NCCL
collectives run on CUDA tensors (and inside a captured CUDA graph), gloo
collectives on host tensors, so the port's helpers (:mod:`.comm`) stage a
CUDA tensor through the host on a gloo group, and only there.

``replicated`` and ``data_sharding`` are placement descriptors: a
:class:`Placement` holds the mesh and a partition spec, a tuple with one
entry per tensor dim (a mesh dim name or None), as ``PartitionSpec`` holds
them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"

PartitionSpec = Tuple[Optional[str], ...]


def backend(mesh: DeviceMesh) -> str:
    """The backend of the mesh's process group (``"nccl"`` or ``"gloo"``)."""
    return str(dist.get_backend(mesh.get_group(0))).lower()


def make_mesh(data: Optional[int] = None, model: int = 1) -> DeviceMesh:
    """Mesh with ``data`` as the outer axis and ``model`` as the inner one
    over the initialised process group's ranks. ``data=None`` takes every
    rank the ``model`` axis leaves. Its device type, where the collectives'
    tensors live, is ``"cuda"`` on an NCCL group and ``"cpu"`` on gloo.
    Raises on the JAX package's bad shapes, and when no process group is
    initialised."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group of "
            "data * model ranks (init_process_group, or parallel.launch.run_ranks)"
        )
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    device_type = "cuda" if str(dist.get_backend()).lower() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_from_config(cfg: MeshConfig) -> DeviceMesh:
    return make_mesh(cfg.data, cfg.model)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (JAX's ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


@dataclass(frozen=True)
class Placement:
    """How a tensor lies on a mesh (JAX's ``NamedSharding``): dim ``i`` is
    split over mesh dim ``spec[i]`` (None: whole); dims past the spec are
    whole."""

    mesh: DeviceMesh
    spec: PartitionSpec = ()


def replicated(mesh: DeviceMesh) -> Placement:
    return Placement(mesh, ())


def data_sharding(mesh: DeviceMesh) -> Placement:
    """Leading-axis (batch) sharding over the data axis."""
    return Placement(mesh, (DATA_AXIS,))
