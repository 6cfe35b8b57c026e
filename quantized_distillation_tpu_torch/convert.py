"""Weight bridge between the JAX package's flax parameter tree and the port.

The flax tree of ``models/seq2seq.py`` (``variables["params"]``, its leaves
turned into numpy arrays with ``jax.tree.map(np.asarray, ...)``) is the
exchange format: :func:`params_from_numpy` turns it into the same nested
layout with f32 torch tensors, which :meth:`Seq2Seq.load_params` and
:func:`..serve.infer.pack_decoder` both read; :func:`params_to_numpy`
exports a port model (or its gradients) back into it, and
:func:`flax_leaves` / :func:`fuse_flax_leaves` view the port's fused
parameters leaf by leaf under flax's path names (``decoder/lstm_0/ii/kernel``),
which is how the training slice buckets them. A learned-codebook tree is a
flat dict from flax path to its ``[2^bits]`` points, keyed as the JAX
package's ``path_str`` keys it: :func:`codebooks_from_numpy` and
:func:`codebooks_to_numpy` carry it between the packages unchanged. Layouts
are kept as flax has them:

- ``Dense`` kernels are ``[in, out]`` (the port multiplies ``x @ kernel``);
- an ``OptimizedLSTMCell`` holds input kernels ``ii, if, ig, io`` (no bias)
  and recurrent kernels ``hi, hf, hg, ho`` with biases, gate order i, f, g, o;
- the encoder's cells are ``OptimizedLSTMCell_{n}`` in creation order: the
  bidirectional encoder's layer ``i`` has its forward cell at ``2i`` and its
  backward cell at ``2i + 1`` (flax names the cells, not the ``lstm_fw_{i}``
  / ``lstm_bw_{i}`` RNNs around them), which is the port's
  ``encoder.cells`` order, so one mapping serves both encoders;
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
_CELL = re.compile(r"(encoder|decoder)\.cells\.(\d+)\.(wi|wh|bh)$")
_CELL_LEAF = {"wi": ("i", "kernel"), "wh": ("h", "kernel"), "bh": ("h", "bias")}


def flax_paths(name: str) -> List[str]:
    """The flax leaf paths that make up the port parameter ``name`` (a
    ``Seq2Seq.named_parameters()`` name), in the order they sit side by side
    along its last dim: one path, or the four gate blocks i, f, g, o of a
    fused LSTM tensor."""
    if name in _NAMED:
        return [_NAMED[name]]
    m = _CELL.match(name)
    if m is None:
        raise KeyError(f"no flax leaf for port parameter {name!r}")
    side, i, kind = m.groups()
    cell = f"encoder/OptimizedLSTMCell_{i}" if side == "encoder" else f"decoder/lstm_{i}"
    pre, leaf = _CELL_LEAF[kind]
    return [f"{cell}/{pre}{g}/{leaf}" for g in GATES]


def flax_leaves(params: Mapping[str, torch.Tensor]) -> List[Tuple[str, torch.Tensor]]:
    """``(flax path, tensor)`` for every flax leaf of the port parameters
    ``params`` (name → tensor, as ``named_parameters()`` gives them), in the
    flax tree's leaf order. A gate leaf is a column-block view of its fused
    tensor, so it is not contiguous."""
    out = []
    for name, t in params.items():
        paths = flax_paths(name)
        out.extend(zip(paths, t.chunk(len(paths), dim=-1)))
    return sorted(out, key=lambda kv: kv[0].split("/"))


def fuse_flax_leaves(
    leaves: Mapping[str, torch.Tensor], names: Iterable[str]
) -> Dict[str, torch.Tensor]:
    """Port parameters ``names`` assembled from flax leaves (path → tensor):
    the inverse of :func:`flax_leaves`."""
    out = {}
    for name in names:
        parts = [leaves[p] for p in flax_paths(name)]
        out[name] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return out


def params_to_numpy(params) -> Tree:
    """A port :class:`..models.seq2seq.Seq2Seq`, or a mapping of its
    parameter names to tensors (its gradients, say) → the flax tree."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    tree: Tree = {}
    for path, t in flax_leaves(params):
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = _np(t)
    return tree


def codebooks_from_numpy(books: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Codebook tree (flax path → ``[2^bits]`` array) → f32 CPU tensors."""
    return {path: params_from_numpy(v) for path, v in books.items()}


def codebooks_to_numpy(books: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's codebook tree → flax path → f32 numpy array."""
    return {path: _np(t) for path, t in books.items()}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()
