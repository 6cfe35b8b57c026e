"""Weight bridge between the JAX package's flax parameter trees and the port.

A flax tree (``variables["params"]``, or ``variables["batch_stats"]``, its
leaves turned into numpy arrays with ``jax.tree.map(np.asarray, ...)``) is
the exchange format: :func:`params_from_numpy` turns it into the same
nested layout with f32 torch tensors, which every model's ``load_params``
and :func:`..serve.infer.pack_decoder` read; :func:`params_to_numpy`
exports a port model (or its gradients) back into it, and
:func:`flax_leaves` / :func:`fuse_flax_leaves` view the port's parameters
leaf by leaf under flax's path names and layouts (``decoder/lstm_0/ii/kernel``,
``BasicBlock_0/Conv_0/kernel``), which is how the training slice buckets
them. A learned-codebook tree is a flat dict from flax path to its
``[2^bits]`` points, keyed as the JAX package's ``path_str`` keys it:
:func:`codebooks_from_numpy` and :func:`codebooks_to_numpy` carry it
between the packages unchanged. :func:`batch_stats_from_numpy` and
:func:`batch_stats_to_numpy` carry flax's BatchNorm statistics
(``<path>/mean``, ``<path>/var``) to and from the port's running-statistics
buffers (``<module>.running_mean``, ``<module>.running_var``).

A port parameter's flax path: the seq2seq family's names are mapped one by
one; the other families name their submodules as flax does, so the dotted
name is the path (``BasicBlock_0.Conv_0.kernel``), except that a
BatchNorm's ``weight`` is flax's ``scale``. Layouts are kept as flax has
them, with one exception:

- ``Dense`` kernels are ``[in, out]`` (the port multiplies ``x @ kernel``);
- conv kernels are OIHW in the port and HWIO in flax: a conv leaf's flax
  view is ``w.permute(2, 3, 1, 0)``. Bucketing flattens the flax view
  row-major, as the JAX package does; flattening OIHW would put other
  weights in every bucket;
- an ``OptimizedLSTMCell`` holds input kernels ``ii, if, ig, io`` (no bias)
  and recurrent kernels ``hi, hf, hg, ho`` with biases, gate order i, f, g,
  o; the port fuses each kind into one tensor (``wi``, ``wh``, ``bh``);
- the seq2seq encoder's cells are ``OptimizedLSTMCell_{n}`` in creation
  order: the bidirectional encoder's layer ``i`` has its forward cell at
  ``2i`` and its backward cell at ``2i + 1`` (flax names the cells, not the
  ``lstm_fw_{i}`` / ``lstm_bw_{i}`` RNNs around them), which is the port's
  ``encoder.cells`` order, so one mapping serves both encoders; the LM's
  cells sit at the top level as ``OptimizedLSTMCell_{i}``, and so do the
  port's;
- ``embedding`` tables are ``[vocab, embed]``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

GATES = ("i", "f", "g", "o")

Tree = Dict[str, Any]


def params_from_numpy(tree: Tree) -> Tree:
    """Nested dicts of numpy arrays → the same nesting of f32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind != "f":
        raise ValueError(f"expected a float parameter array, got {arr.dtype}")
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def fuse_lstm_params(cell: Tree) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cell's flax params → (input kernel [E_in, 4H], recurrent kernel
    [H, 4H], recurrent bias [4H]), gate blocks in order i, f, g, o."""
    wi = torch.cat([torch.as_tensor(cell[f"i{g}"]["kernel"]) for g in GATES], dim=1)
    wh = torch.cat([torch.as_tensor(cell[f"h{g}"]["kernel"]) for g in GATES], dim=1)
    bh = torch.cat([torch.as_tensor(cell[f"h{g}"]["bias"]) for g in GATES])
    return wi, wh, bh


_NAMED = {
    "encoder.embedding": "encoder/embed/embedding",
    "decoder.attn.linear_in": "decoder/attn/linear_in/kernel",
    "decoder.attn.linear_out": "decoder/attn/linear_out/kernel",
    "tgt_embed": "tgt_embed/embedding",
    "generator_kernel": "generator/kernel",
    "generator_bias": "generator/bias",
}
_CELL = re.compile(r"(.+)\.(wi|wh|bh)$")
_SEQ2SEQ_CELL = re.compile(r"(encoder|decoder)\.cells\.(\d+)$")
_CELL_LEAF = {"wi": ("i", "kernel"), "wh": ("h", "kernel"), "bh": ("h", "bias")}
_LEAF = {"weight": "scale"}  # BatchNorm
_STATS = {"running_mean": "mean", "running_var": "var"}


def _cell_path(module: str) -> str:
    m = _SEQ2SEQ_CELL.match(module)
    if m is None:
        return module.replace(".", "/")
    side, i = m.groups()
    return f"encoder/OptimizedLSTMCell_{i}" if side == "encoder" else f"decoder/lstm_{i}"


def flax_paths(name: str) -> List[str]:
    """The flax leaf paths that make up the port parameter ``name`` (a
    ``named_parameters()`` name of any port model), in the order they sit
    side by side along its last dim: one path, or the four gate blocks i,
    f, g, o of a fused LSTM tensor."""
    if name in _NAMED:
        return [_NAMED[name]]
    m = _CELL.match(name)
    if m is not None:
        module, kind = m.groups()
        pre, leaf = _CELL_LEAF[kind]
        return [f"{_cell_path(module)}/{pre}{g}/{leaf}" for g in GATES]
    *modules, leaf = name.split(".")
    return ["/".join(modules + [_LEAF.get(leaf, leaf)])]


def to_flax_layout(t: torch.Tensor) -> torch.Tensor:
    """A port leaf viewed in flax's layout: OIHW conv kernels as HWIO."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def from_flax_layout(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_flax_layout`."""
    return t.permute(3, 2, 0, 1) if t.dim() == 4 else t


def flax_leaves(params: Mapping[str, torch.Tensor]) -> List[Tuple[str, torch.Tensor]]:
    """``(flax path, tensor)`` for every flax leaf of the port parameters
    ``params`` (name → tensor, as ``named_parameters()`` gives them), in the
    flax tree's leaf order and layout. A gate leaf is a column-block view of
    its fused tensor and a conv leaf a permuted view, so neither is
    contiguous."""
    out = []
    for name, t in params.items():
        paths = flax_paths(name)
        out.extend(zip(paths, map(to_flax_layout, t.chunk(len(paths), dim=-1))))
    return sorted(out, key=lambda kv: kv[0].split("/"))


def fuse_flax_leaves(
    leaves: Mapping[str, torch.Tensor], names: Iterable[str]
) -> Dict[str, torch.Tensor]:
    """Port parameters ``names`` assembled from flax leaves (path → tensor,
    in flax's layout): the inverse of :func:`flax_leaves`."""
    out = {}
    for name in names:
        parts = [leaves[p] for p in flax_paths(name)]
        out[name] = from_flax_layout(parts[0]) if len(parts) == 1 else torch.cat(parts, dim=-1)
    return out


def flatten_tree(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts → ``{"a/b/c": leaf}``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flatten_tree(v, path) if isinstance(v, dict) else {path: v})
    return out


def _unflatten(flat: Mapping[str, Any]) -> Tree:
    tree: Tree = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def params_to_numpy(params) -> Tree:
    """A port model, or a mapping of its parameter names to tensors (its
    gradients, say) → the flax tree."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return _unflatten({path: _np(t) for path, t in flax_leaves(params)})


def batch_stats_from_numpy(tree: Tree) -> Dict[str, torch.Tensor]:
    """A flax ``batch_stats`` tree → the port's running statistics (buffer
    name → f32 CPU tensor: ``<module>.running_mean`` / ``running_var``)."""
    inverse = {v: k for k, v in _STATS.items()}
    out = {}
    for path, t in flatten_tree(params_from_numpy(tree)).items():
        *modules, leaf = path.split("/")
        out[".".join(modules + [inverse[leaf]])] = t
    return out


def batch_stats_to_numpy(stats) -> Tree:
    """A port model, or a mapping of its buffer names to running statistics
    → the flax ``batch_stats`` tree."""
    if isinstance(stats, torch.nn.Module):
        stats = dict(stats.named_buffers())
    flat = {}
    for name, t in stats.items():
        *modules, leaf = name.split(".")
        flat["/".join(modules + [_STATS[leaf]])] = _np(t)
    return _unflatten(flat)


def codebooks_from_numpy(books: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Codebook tree (flax path → ``[2^bits]`` array) → f32 CPU tensors."""
    return {path: params_from_numpy(v) for path, v in books.items()}


def codebooks_to_numpy(books: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's codebook tree → flax path → f32 numpy array."""
    return {path: _np(t) for path, t in books.items()}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()
