"""Sharding rules: partition specs for parameters and batches, and placement
(the PyTorch port of the JAX package's ``parallel/sharding.py``).

The rule table is the JAX package's tensor-parallel layout for the LSTM
families: embedding rows, LSTM gate columns, the attention kernels' columns
and the generator's vocab columns over ``model``; everything else
replicated. A spec is a tuple with one entry per tensor dim, a mesh dim
name or None (JAX's ``PartitionSpec`` as a tuple: ``P(None, "model")`` is
``(None, "model")``, ``P()`` is ``()``).

Rules match flax paths (``decoder/lstm_0/ii/kernel``). A parameter tree is
either the flax-layout tree of nested dicts (``convert.params_from_numpy``:
the path is the keys joined with ``/``) or a port model's flat
``named_parameters()`` mapping, whose names ``convert.flax_paths`` maps to
flax paths. A fused LSTM tensor (``wi``, ``wh``, ``bh``: the four gate
blocks i, f, g, o side by side along the last dim) shards block by block:
its local tensor is the four blocks' local slices side by side, which is
what the four flax leaves' shards are.

Placement returns this rank's local tensors: rank ``(d, m)`` of the mesh
holds the slice that JAX's ``addressable_shards`` hold for mesh position
``(d, m)``, bit for bit. A split dim must divide its mesh dim; the
parameter placements fall back to replication where it does not, as the
JAX package's do.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..convert import flax_paths
from .mesh import DATA_AXIS, MODEL_AXIS, Placement, PartitionSpec, axis_index, axis_size

PyTree = Any

# (path regex, rank) → spec. First match wins.
_SEQ2SEQ_RULES: List[Tuple[str, Callable[[int], PartitionSpec]]] = [
    (r"embedding$", lambda r: (MODEL_AXIS, None)),
    (r"generator/kernel$", lambda r: (None, MODEL_AXIS)),
    (r"generator/bias$", lambda r: (MODEL_AXIS,)),
    (r"(ii|if|ig|io|hi|hf|hg|ho)/kernel$", lambda r: (None, MODEL_AXIS)),
    (r"(hi|hf|hg|ho)/bias$", lambda r: (MODEL_AXIS,)),
    (r"attn/linear_(in|out)/kernel$", lambda r: (None, MODEL_AXIS)),
]


def _map(fn: Callable, tree: PyTree, path: Tuple[str, ...] = ()) -> PyTree:
    """``fn(key path, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def _map2(fn: Callable, tree: PyTree, specs: PyTree) -> PyTree:
    if isinstance(tree, Mapping):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def _paths(key_path: Tuple[str, ...]) -> List[str]:
    """The flax path(s) of a leaf: the joined keys of a nested tree, or a
    flat port name's (``convert.flax_paths``: four for a fused gate
    tensor)."""
    if len(key_path) == 1:
        return flax_paths(key_path[0])
    return ["/".join(key_path)]


def _rule(path: str, ndim: int) -> PartitionSpec:
    for pat, spec in _SEQ2SEQ_RULES:
        if re.search(pat, path):
            return spec(ndim)
    return ()


def seq2seq_pspecs(params: PyTree) -> PyTree:
    """Spec tree for seq2seq (and LM) params: tensor parallel over
    ``model``."""
    return _map(lambda p, leaf: _rule(_paths(p)[0], np.ndim(leaf)), params)


def replicated_pspecs(params: PyTree) -> PyTree:
    return _map(lambda p, leaf: (), params)


def batch_pspecs(batch: Dict) -> Dict:
    """Shard every batch array along its leading (batch) axis."""
    return _map(lambda p, leaf: (DATA_AXIS,), batch)


def to_named(tree_pspecs: PyTree, mesh) -> PyTree:
    return _map(lambda p, spec: Placement(mesh, tuple(spec)), tree_pspecs)


def _tensor(x) -> torch.Tensor:
    """A leaf as a tensor, out of any autograd graph (a placed copy, like
    JAX's ``device_put``, has no history)."""
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _local(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` under ``spec``; raises if a split dim
    does not divide its mesh dim."""
    for dim, name in enumerate(spec):
        if name is None:
            continue
        n, i = axis_size(mesh, name), axis_index(mesh, name)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not divide "
                             f"mesh axis {name!r} of size {n}")
        w = x.shape[dim] // n
        x = x.narrow(dim, i * w, w)
    return x


def place(tree: PyTree, pspecs: PyTree, mesh, *, device="cuda") -> PyTree:
    """This rank's local tensors of ``tree`` under a spec tree, on
    ``device`` (contiguous copies)."""
    dev = resolve_device(device)
    return _map2(lambda x, s: _local(_tensor(x), s, mesh).to(dev).contiguous(), tree, pspecs)


def place_replicated(tree: PyTree, mesh, *, device="cuda") -> PyTree:
    dev = resolve_device(device)
    return _map(lambda p, x: _tensor(x).to(dev).contiguous(), tree)


def place_batch(batch: Dict, mesh, *, device="cuda") -> Dict:
    """This rank's rows of every batch array (its ``data`` slice)."""
    return place(batch, batch_pspecs(batch), mesh, device=device)


def _fits(shape, spec: PartitionSpec, mesh, blocks: int) -> bool:
    """Whether every split dim divides its mesh dim (the last dim per gate
    block for a fused tensor)."""
    for dim, name in enumerate(spec):
        if name is None:
            continue
        if dim >= len(shape):
            return False
        size = shape[dim] // blocks if dim == len(shape) - 1 else shape[dim]
        if size % axis_size(mesh, name):
            return False
    return True


def _spec_fit(key_path, leaf, mesh) -> PartitionSpec:
    """The rule's spec for a leaf, or ``()`` where a split dim does not
    divide its mesh dim."""
    x = _tensor(leaf)
    paths = _paths(key_path)
    spec = _rule(paths[0], x.dim())
    return spec if _fits(tuple(x.shape), spec, mesh, len(paths)) else ()


def placed_pspecs(params: PyTree, mesh) -> PyTree:
    """The spec tree :func:`place_params_seq2seq` applies on ``mesh``: the
    tensor-parallel rules, with replication wherever a split dim does not
    divide its mesh dim. ``make_train_step(param_specs=)`` takes it (of a
    port model's whole ``named_parameters()``)."""
    return _map(lambda p, leaf: _spec_fit(p, leaf, mesh), params)


def shard(x: torch.Tensor, spec: PartitionSpec, mesh, blocks: int = 1) -> torch.Tensor:
    """This rank's slice of the whole tensor ``x`` under ``spec``; a fused
    tensor of ``blocks`` gate blocks along its last dim is split block by
    block (its slice is the blocks' slices side by side)."""
    if blocks > 1 and spec:
        return torch.cat([_local(b, spec, mesh) for b in x.chunk(blocks, dim=-1)], dim=-1)
    return _local(x, spec, mesh)


def unshard(parts: Sequence[torch.Tensor], spec: PartitionSpec, blocks: int = 1) -> torch.Tensor:
    """The whole tensor from every rank's slice along the one split dim of
    ``spec`` (``parts`` in axis order): the inverse of :func:`shard`."""
    dims = [d for d, name in enumerate(spec) if name is not None]
    if len(dims) != 1:
        raise ValueError(f"unshard takes a spec with one split dim, got {spec}")
    d = dims[0]
    if blocks > 1 and d == parts[0].dim() - 1:
        split = [p.chunk(blocks, dim=-1) for p in parts]
        return torch.cat([torch.cat([s[b] for s in split], dim=-1) for b in range(blocks)], dim=-1)
    return torch.cat(list(parts), dim=d)


def place_params_seq2seq(params: PyTree, mesh, *, device="cuda") -> PyTree:
    """This rank's local seq2seq params under the tensor-parallel rules.

    Leaves whose split dim does not divide the mesh axis fall back to
    replication (e.g. odd vocab sizes in tests). The rules are LSTM-family
    generic, so they shard the language model identically
    (:func:`place_params_lm`)."""
    dev = resolve_device(device)

    def put(key_path, leaf):
        x = _tensor(leaf)
        spec = _spec_fit(key_path, x, mesh)
        return shard(x, spec, mesh, len(_paths(key_path))).to(dev).contiguous()

    return _map(put, params)


# The LSTM LM shares the gate/embedding/generator structure: same placement.
place_params_lm = place_params_seq2seq
