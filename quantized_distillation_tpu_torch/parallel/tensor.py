"""Operators of tensor parallelism over the mesh's ``model`` axis, written
out as ``torch.autograd.Function``s (the collectives XLA's partitioner
inserts on its own when the JAX package trains on ``place_params_*``
params).

One process per rank: a rank holds its local shard of every split
parameter (:mod:`.sharding`) and runs the model's tensor-parallel forward
on them (``Seq2Seq.forward_tp``, ``LSTMLanguageModel.forward_tp``). The
gradient convention is Megatron's: a tensor that is whole on every rank of
``model`` ("replicated") carries its whole gradient on every rank, and a
split tensor carries the gradient of its own slice. So:

- :func:`copy_to_model`: identity forward, ``psum`` backward. A replicated
  activation entering split compute (a column-split matmul) gets only its
  rank's share of the gradient there; the shares are summed.
- :func:`reduce_from_model`: ``psum`` forward, identity backward. Partial
  sums (attention scores over a split H, a vocab-split softmax's
  denominator) become replicated.
- :func:`gather_from_model`: all-gather forward, this rank's slice
  backward (no collective). A split activation becomes replicated.
- :func:`gather_to_split`: all-gather forward, reduce-scatter backward:
  :func:`copy_to_model` of :func:`gather_from_model`, for a gathered tensor
  that only split compute consumes (the LSTM's recurrent input ``h``, the
  decoder's input feed).
- :func:`split_to_model`: this rank's slice forward, all-gather backward.
- :func:`vocab_parallel_embedding`: the lookup in a row-split table: the
  ids outside this rank's rows read zeros, then ``psum``.
- :func:`vocab_parallel_logsumexp`, :func:`vocab_parallel_nll`,
  :func:`vocab_parallel_kd_kl`: the log-softmax terms over vocab-split
  logits; the teacher's logits arrive whole and are sliced to the rank's
  columns.

Every collective goes through :mod:`.comm`, so the step's budget records
it. :class:`ModelParallel` carries the mesh and the parameters' specs into
the model's tensor-parallel forward, the fake-quant of split leaves
(``train/quantize_tree.py``) and the global norm (``train/optim.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

from ..convert import flax_paths
from .comm import all_gather, all_gather_dim, pmax, psum, reduce_scatter
from .mesh import MODEL_AXIS, PartitionSpec, axis_index, axis_size
from .sharding import shard, unshard


@dataclass(frozen=True, eq=False)
class ModelParallel:
    """A mesh and the partition specs of a parameter dict (name → spec, as
    :func:`.sharding.placed_pspecs` gives them): which parameters are
    split over ``model``, and this rank's place on it."""

    mesh: object
    specs: Mapping[str, PartitionSpec]

    @property
    def size(self) -> int:
        return axis_size(self.mesh, MODEL_AXIS)

    @property
    def index(self) -> int:
        return axis_index(self.mesh, MODEL_AXIS)

    def is_split(self, name: str) -> bool:
        return MODEL_AXIS in tuple(self.specs.get(name, ()))

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole parameter ``name`` (itself if
        replicated)."""
        if not self.is_split(name):
            return whole
        return shard(whole, tuple(self.specs[name]), self.mesh, len(flax_paths(name)))

    def gather(self, local: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole tensors of the split parameters in ``local`` (name →
        this rank's shard), in ONE all-gather over ``model`` of a flat
        buffer; outside autograd."""
        names = [n for n, t in local.items() if self.is_split(n)]
        if not names:
            return {}
        with torch.no_grad():
            flat = torch.cat([local[n].reshape(-1) for n in names])
            parts = all_gather(flat, self.mesh, MODEL_AXIS)
        out, off = {}, 0
        for n in names:
            t = local[n]
            pieces = [p[off:off + t.numel()].view(t.shape) for p in parts]
            out[n] = unshard(pieces, tuple(self.specs[n]), len(flax_paths(n)))
            off += t.numel()
        return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return psum(x, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]
        return all_gather_dim(x, mesh, MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, g):
        i = axis_index(ctx.mesh, MODEL_AXIS)
        return g.narrow(ctx.dim, i * ctx.width, ctx.width), None, None


class _GatherToSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather_dim(x, mesh, MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, MODEL_AXIS, ctx.dim), None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n, i = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
        w = x.shape[dim] // n
        return x.narrow(dim, i * w, w).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.mesh, MODEL_AXIS, ctx.dim), None, None


# Each operator takes ``mp`` (a ModelParallel, or None: the identity, for a
# part of the model that runs whole on every rank).


def copy_to_model(x: torch.Tensor, mp: Optional[ModelParallel]) -> torch.Tensor:
    return x if mp is None else _CopyToModel.apply(x, mp.mesh)


def reduce_from_model(x: torch.Tensor, mp: Optional[ModelParallel]) -> torch.Tensor:
    return x if mp is None else _ReduceFromModel.apply(x, mp.mesh)


def gather_from_model(x: torch.Tensor, mp: Optional[ModelParallel], dim: int = -1) -> torch.Tensor:
    return x if mp is None else _GatherFromModel.apply(x, mp.mesh, dim % x.dim())


def gather_to_split(x: torch.Tensor, mp: Optional[ModelParallel], dim: int = -1) -> torch.Tensor:
    return x if mp is None else _GatherToSplit.apply(x, mp.mesh, dim % x.dim())


def split_to_model(x: torch.Tensor, mp: Optional[ModelParallel], dim: int = -1) -> torch.Tensor:
    return x if mp is None else _SplitToModel.apply(x, mp.mesh, dim % x.dim())


def local_columns(x: Optional[torch.Tensor], mp: Optional[ModelParallel]):
    """This rank's block of the last dim of a tensor outside autograd (a
    dropout mask, a detached carry, the teacher's logits); None stays
    None."""
    if mp is None or x is None:
        return x
    w = x.shape[-1] // mp.size
    return x[..., mp.index * w:(mp.index + 1) * w]


def _owned(ids: torch.Tensor, rows: int, mp: ModelParallel):
    """(local ids clamped into range, whether this rank owns each id) for a
    dim of ``rows`` per rank."""
    local = ids.long() - mp.index * rows
    inside = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), inside


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor,
                             mp: Optional[ModelParallel]) -> torch.Tensor:
    """``whole_table[ids]`` from this rank's rows of a row-split table
    (``mp`` None: ``table[ids]``); replicated output."""
    if mp is None:
        return table[ids]
    local, inside = _owned(ids, table.shape[0], mp)
    rows = table[local]
    return reduce_from_model(torch.where(inside[..., None], rows, torch.zeros_like(rows)), mp)


def vocab_parallel_logsumexp(logits: torch.Tensor, mp: Optional[ModelParallel]) -> torch.Tensor:
    """logsumexp over the whole vocab of vocab-split ``logits`` [..., V/m]
    → [...], replicated: the shards' maximum (``pmax``, no gradient), then
    the ``psum`` of each shard's sum of exponentials."""
    if mp is None:
        return torch.logsumexp(logits, dim=-1)
    m = pmax(logits.detach().amax(dim=-1), mp.mesh, MODEL_AXIS)
    s = reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1), mp)
    return m + torch.log(s)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       mp: Optional[ModelParallel]) -> torch.Tensor:
    """``-log_softmax(logits)[labels]`` over vocab-split ``logits`` [...,
    V/m] with whole-vocab ``labels`` [...] → [...], replicated."""
    if mp is None:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    lse = vocab_parallel_logsumexp(logits, mp)
    local, inside = _owned(labels, logits.shape[-1], mp)
    picked = torch.gather(logits, -1, local[..., None])[..., 0]
    return lse - reduce_from_model(torch.where(inside, picked, torch.zeros_like(picked)), mp)


def vocab_parallel_kd_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                         temperature: float, mp: Optional[ModelParallel]) -> torch.Tensor:
    """Per-position KL(softmax_T(teacher) || softmax_T(student)) [...] for
    vocab-split student logits [..., V/m] and the whole teacher logits [...,
    V] (no gradient), replicated; not yet T²-scaled or masked."""
    t = temperature
    p_teacher = torch.softmax(teacher_logits / t, dim=-1)
    logp_teacher = torch.log_softmax(teacher_logits / t, dim=-1)
    if mp is None:
        logp_student = torch.log_softmax(student_logits / t, dim=-1)
        return (p_teacher * (logp_teacher - logp_student)).sum(dim=-1)
    scaled = student_logits / t
    # the whole lse enters each rank's columns: its gradient is summed
    logp_student = scaled - copy_to_model(vocab_parallel_logsumexp(scaled, mp), mp)[..., None]
    part = (local_columns(p_teacher, mp)
            * (local_columns(logp_teacher, mp) - logp_student)).sum(dim=-1)
    return reduce_from_model(part, mp)


__all__ = [
    "ModelParallel",
    "copy_to_model",
    "reduce_from_model",
    "gather_from_model",
    "gather_to_split",
    "split_to_model",
    "local_columns",
    "vocab_parallel_embedding",
    "vocab_parallel_logsumexp",
    "vocab_parallel_nll",
    "vocab_parallel_kd_kl",
]
