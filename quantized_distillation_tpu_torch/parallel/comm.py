"""Collectives over a mesh axis, and the per-call collective budget (the
PyTorch port's counterpart of the JAX package's ``parallel/comm.py``).

The JAX package reads the collectives of a step from its compiled HLO; the
port has no HLO, so every collective of its multi-device paths goes through
the helpers here (:func:`all_gather`, :func:`all_gather_dim`, :func:`psum`,
:func:`pmean`, :func:`pmax`, :func:`reduce_scatter`), and each one records
itself: kind, payload bytes (the gathered output of an all-gather, the
reduced tensor of an all-reduce, the scattered output of a reduce-scatter:
the result shape, as XLA's HLO writes it), the
mesh axis its groups vary along (:func:`_axis_of_groups`) and the group
size. ``with collective_budget(mesh) as budget: step(...)`` collects them.
An axis of size 1 still issues and records its collective, so a one-rank
NCCL run goes through the real path. A CUDA graph keeps the collectives its
capture issued and records them again at every replay, as it does for
kernel launches (this module registers itself with
:func:`..utils.graphs.register_recorder`).

On a gloo group a CUDA tensor is staged through the host (gloo's
collectives take host tensors); on an NCCL group the tensors stay on the
card and a collective can be captured in a CUDA graph. The backend is the
process group's; nothing switches it.

``CollectiveOp.wire_bytes``, ``CommBudget``, ``format_budget`` and
``scaling_estimate`` are the JAX package's, on the same inputs with the same
results.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.graphs import register_recorder
from .mesh import DATA_AXIS, axis_size, backend


@dataclass
class CollectiveOp:
    kind: str
    bytes: int  # payload tensor bytes (per participating device)
    axis: str  # 'data' | 'model' | 'mixed' | 'unknown'
    group_size: int

    def wire_bytes(self) -> int:
        """Ring-algorithm bytes each device sends for this collective."""
        g = max(self.group_size, 1)
        if self.kind == "all-reduce":
            return int(2 * (g - 1) / g * self.bytes)
        if self.kind in ("all-gather", "reduce-scatter"):
            return int((g - 1) / g * self.bytes)
        if self.kind == "all-to-all":
            return int((g - 1) / g * self.bytes)
        return self.bytes  # collective-permute: one hop


@dataclass
class CommBudget:
    ops: List[CollectiveOp] = field(default_factory=list)

    def bytes_by_axis(self, wire: bool = True) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            b = op.wire_bytes() if wire else op.bytes
            out[op.axis] = out.get(op.axis, 0) + b
        return out

    def count(self, kind: str) -> int:
        return sum(op.kind == kind for op in self.ops)


def _axis_of_groups(groups: List[List[int]], mesh) -> str:
    """Which mesh axis a rank-group pattern communicates over: the single
    mesh dim its groups vary along, ``'mixed'`` if several, ``'unknown'``
    for singleton groups. ``mesh`` is a ``DeviceMesh`` (its ``mesh`` tensor
    of ranks and its dim names), of any rank."""
    arr = np.asarray(mesh.mesh.cpu())
    coords = {int(arr[idx]): idx for idx in np.ndindex(arr.shape)}
    varying: set = set()
    for g in groups:
        cs = [coords[d] for d in g if d in coords]
        if len(cs) <= 1:
            continue
        for ax in range(arr.ndim):
            if len({c[ax] for c in cs}) > 1:
                varying.add(ax)
    if not varying:
        return "unknown"  # singleton groups
    if len(varying) == 1:
        return str(mesh.mesh_dim_names[varying.pop()])
    return "mixed"


def axis_groups(mesh, axis: str) -> List[List[int]]:
    """The rank groups of ``axis``: one list of ranks per position on the
    other mesh dims."""
    dim = mesh.mesh_dim_names.index(axis)
    arr = np.moveaxis(np.asarray(mesh.mesh.cpu()), dim, -1)
    return arr.reshape(-1, arr.shape[-1]).tolist()


# budgets being filled (collective_budget) with the mesh each takes (None:
# any) and, innermost first, the lists a graph capture redirects records into
_budgets: List[Tuple[CommBudget, object]] = []
_redirect: List[Optional[List[Tuple[CollectiveOp, object]]]] = []


def _record(op: CollectiveOp, mesh) -> None:
    if _redirect:
        if _redirect[-1] is not None:
            _redirect[-1].append((op, mesh))
        return
    for budget, of in _budgets:
        if of is None or of is mesh:
            budget.ops.append(op)


def record_ops(ops: List[Tuple[CollectiveOp, object]], times: int = 1) -> None:
    """Record ``(op, mesh)`` pairs ``times`` times into the open budgets (a
    replayed graph's collectives)."""
    for _ in range(times):
        for op, mesh in ops:
            _record(op, mesh)


@contextlib.contextmanager
def redirected(into: Optional[list]) -> Iterator[None]:
    """Inside the block collectives are recorded into ``into`` (None: not
    at all) instead of the open budgets."""
    _redirect.append(into)
    try:
        yield
    finally:
        _redirect.pop()


register_recorder(redirected, record_ops)


@contextlib.contextmanager
def collective_budget(mesh=None) -> Iterator[CommBudget]:
    """Collect the collectives the port's helpers issue inside the block
    over ``mesh`` (None: over any mesh)."""
    entry = (CommBudget(), mesh)
    _budgets.append(entry)
    try:
        yield entry[0]
    finally:
        _budgets.remove(entry)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _staged(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` where the group's backend takes it: on the host for gloo, on
    the card for NCCL (a host tensor raises there)."""
    be = backend(mesh)
    if be == "gloo":
        return x.detach().cpu().contiguous()
    if be == "nccl" and not x.is_cuda:
        raise ValueError("an NCCL collective needs a CUDA tensor")
    return x.detach().contiguous()


def _op(kind: str, nbytes: int, mesh, axis: str) -> None:
    groups = axis_groups(mesh, axis)
    _record(CollectiveOp(kind, int(nbytes), _axis_of_groups(groups, mesh), len(groups[0])), mesh)


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked in axis order →
    ``[axis size, *x.shape]`` on ``x``'s device (JAX's
    ``lax.all_gather``)."""
    group = _group(mesh, axis)
    g = dist.get_world_size(group)
    y = _staged(x, mesh)
    if y.is_cuda:
        out = torch.empty((g,) + tuple(y.shape), dtype=y.dtype, device=y.device)
        dist.all_gather_into_tensor(out, y, group=group)
    else:
        parts = [torch.empty_like(y) for _ in range(g)]
        dist.all_gather(parts, y, group=group)
        out = torch.stack(parts)
    _op("all-gather", out.numel() * out.element_size(), mesh, axis)
    return out.to(x.device)


def all_gather_dim(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated along tensor dim
    ``dim``, in axis order (JAX's ``lax.all_gather(tiled=True)``): one
    recorded all-gather."""
    g = all_gather(x, mesh, axis)
    dim = dim % x.dim()
    return g.movedim(0, dim).flatten(dim, dim + 1)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Sum of every rank's ``x`` along ``axis``, of which this rank keeps its
    block of tensor dim ``dim`` (the axis index-th of ``axis size`` equal
    blocks; JAX's ``lax.psum_scatter(scatter_dimension=dim, tiled=True)``).
    ``x.shape[dim]`` must divide the axis."""
    group = _group(mesh, axis)
    g = dist.get_world_size(group)
    dim = dim % x.dim()
    if x.shape[dim] % g:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not divide axis {axis!r} "
                         f"of size {g}")
    y = _staged(x.movedim(dim, 0), mesh)  # contiguous: the blocks are rows
    out = torch.empty((y.shape[0] // g,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
    dist.reduce_scatter_tensor(out, y, group=group)
    _op("reduce-scatter", out.numel() * out.element_size(), mesh, axis)
    return out.movedim(0, dim).to(x.device)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise maximum of every rank's ``x`` along ``axis`` (JAX's
    ``lax.pmax``), on ``x``'s device."""
    y = _staged(x, mesh).clone()  # reduced in place: never x
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=_group(mesh, axis))
    _op("all-reduce", y.numel() * y.element_size(), mesh, axis)
    return y.to(x.device)


def psum(x: torch.Tensor, mesh, axis: str, *, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Sum of every rank's ``x`` along ``axis``, carried in ``dtype``
    (default ``x``'s) and returned in ``x``'s dtype on its device (JAX's
    ``lax.psum`` of ``x.astype(dtype)``, cast back)."""
    y = _staged(x, mesh).to(dtype or x.dtype, copy=True)  # reduced in place: never x
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
    _op("all-reduce", y.numel() * y.element_size(), mesh, axis)
    return y.to(x.device, x.dtype)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mean of every rank's ``x`` along ``axis`` (JAX's ``lax.pmean``)."""
    return psum(x, mesh, axis) / dist.get_world_size(_group(mesh, axis))


def capturable(mesh, device) -> bool:
    """Whether a path over ``mesh`` on ``device`` runs as a CUDA graph: on
    the card over NCCL, whose collectives a graph holds (gloo's go through
    the host). The one rule of every graphed mesh path: the sharded search,
    the engine and the train step."""
    return torch.device(device).type == "cuda" and backend(mesh) == "nccl"


_warm: "weakref.WeakSet" = weakref.WeakSet()
# elements a rank of each warm-up collective: NCCL picks its protocol and
# algorithm by size, so each kind is issued at a few sizes
WARM_SIZES = (1, 1 << 14, 1 << 22)


def warm_up(mesh) -> None:
    """Every collective kind a graphed path holds, unrecorded, over each mesh
    axis at each of ``WARM_SIZES``, once per mesh: an all-gather, an
    all-reduce sum in f32 and in bf16 (the reduced gradient reduce), an
    all-reduce max and a reduce-scatter. NCCL creates a group's communicator
    at its first collective and may set up a kind's buffers at its first
    call, neither of which a CUDA graph capture can hold, so the graphed
    paths call this before their first capture."""
    if mesh in _warm:
        return
    nccl = backend(mesh) == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    with redirected(None):
        for axis in mesh.mesh_dim_names:
            g = axis_size(mesh, axis)
            for n in WARM_SIZES:
                x = torch.zeros(n * g, device=dev)
                all_gather(x, mesh, axis)
                psum(x, mesh, axis)
                psum(x, mesh, axis, dtype=torch.bfloat16)
                pmax(x, mesh, axis)
                reduce_scatter(x, mesh, axis, 0)
    if nccl:
        torch.cuda.synchronize(dev)
    _warm.add(mesh)


def format_budget(budget: CommBudget) -> str:
    by_axis = budget.bytes_by_axis(wire=True)
    lines = [
        f"collectives: {len(budget.ops)} "
        + " ".join(f"{a}={b / 1e6:.3f}MB" for a, b in sorted(by_axis.items()))
    ]
    kinds: Dict[str, int] = {}
    for op in budget.ops:
        key = f"{op.kind}@{op.axis}"
        kinds[key] = kinds.get(key, 0) + 1
    lines.append("  " + " ".join(f"{k}x{v}" for k, v in sorted(kinds.items())))
    return "\n".join(lines)


def scaling_estimate(
    budget: CommBudget,
    step_seconds: float,
    *,
    hosts: int = 2,
    dcn_bytes_per_s: float = 25e9,
    overlap: bool = False,
) -> Dict[str, float]:
    """Analytic 1→``hosts`` data-parallel scaling efficiency: the ``data``
    axis' ring bytes at group size ``hosts`` over ``dcn_bytes_per_s``, after
    the step (``overlap``: hidden under it). Efficiency = step time over
    modelled step time."""
    dcn_bytes = sum(
        CollectiveOp(op.kind, op.bytes, op.axis, hosts).wire_bytes()
        for op in budget.ops
        if op.axis == DATA_AXIS
    )
    t_comm = dcn_bytes / dcn_bytes_per_s
    t_step = max(step_seconds, t_comm) if overlap else step_seconds + t_comm
    return {
        "hosts": float(hosts),
        "dcn_bytes_per_step": float(dcn_bytes),
        "t_comm_s": t_comm,
        "t_step_1host_s": step_seconds,
        "efficiency": step_seconds / t_step,
    }
