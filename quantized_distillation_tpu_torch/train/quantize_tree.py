"""Parameter-tree quantization transforms (PyTorch port of the JAX
package's ``train/quantize_tree.py``).

``params`` is a mapping of the port model's parameter names to tensors
(``dict(model.named_parameters())``). The JAX package buckets each flax
leaf on its own, flattened row-major; the port stores an LSTM cell's four
gate kernels side by side in one fused tensor, and bucketing that tensor
would cut other buckets wherever H is not a multiple of the bucket size.
So every transform here works on the flax view of the parameters
(:func:`..convert.flax_leaves`: each leaf under its flax path, in flax leaf
order) and assembles the per-leaf results back into fused tensors
(:func:`..convert.fuse_flax_leaves`). Paths are flax's ``a/b/c`` names
(``decoder/lstm_0/ii/kernel``), so ``QuantSpec.exclude_substrings`` and
``bits_map`` keys read the same in both packages.

Quantizable leaves: ndim >= 2 (kernels, embeddings) and no excluded
substring in the path; biases stay full precision. The learned-codebook
transforms come with differentiable quantization (slice 3 of the port).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import QuantSpec
from ..convert import flax_leaves, flax_paths, fuse_flax_leaves
from ..kernels.fake_quant import fake_quant_buckets
from ..ops import uniform
from ..ops.bucketing import from_buckets, to_buckets

Params = Mapping[str, torch.Tensor]

_CODEBOOKS = "learned codebooks (method='codebook') come with slice 3 of the port"


def is_quantizable(path: str, leaf: torch.Tensor, spec: QuantSpec) -> bool:
    return leaf.dim() >= 2 and not spec.excludes(path)


def map_quantizable(
    fn: Callable[[str, torch.Tensor], torch.Tensor], params: Params, spec: QuantSpec
) -> Dict[str, torch.Tensor]:
    """``fn(path, leaf)`` on every quantizable flax leaf, in flax leaf
    order; a parameter with no quantizable leaf is returned as it is, the
    others are reassembled from their (mapped or unchanged) leaves."""
    leaves = flax_leaves(params)
    mapped = {p: fn(p, x) for p, x in leaves if is_quantizable(p, x, spec)}
    names = [n for n in params if any(p in mapped for p in flax_paths(n))]
    return {**params, **fuse_flax_leaves({**dict(leaves), **mapped}, names)}


def _bits(path: str, spec: QuantSpec, bits_map: Optional[Dict[str, int]]) -> int:
    return bits_map.get(path, spec.bits) if bits_map else spec.bits


def _fused_fake_quant_values(
    params: Params, spec: QuantSpec, bits_map: Optional[Dict[str, int]]
) -> Optional[Dict[str, torch.Tensor]]:
    """Fake-quant values of every quantizable leaf (path → tensor) through
    ONE :func:`..kernels.fake_quant.fake_quant_buckets` call per bits-group
    over the concatenated buckets of all its leaves; None for stochastic
    rounding or a bucket size the kernel does not take. Bucketing stays per
    leaf, so the values are the per-leaf pipeline's."""
    if spec.stochastic or spec.bucket_size % 128:
        return None
    groups: Dict[int, list] = {}
    for path, leaf in flax_leaves(params):
        if is_quantizable(path, leaf, spec):
            groups.setdefault(_bits(path, spec, bits_map), []).append((path, leaf))
    out: Dict[str, torch.Tensor] = {}
    for bits, leaves in groups.items():
        blocks = [to_buckets(leaf.detach().contiguous(), spec.bucket_size) for _, leaf in leaves]
        q = fake_quant_buckets(torch.cat([b for b, _ in blocks]), bits, scaling=spec.scaling)
        for (path, leaf), (b, n), qb in zip(leaves, blocks, q.split([b.shape[0] for b, _ in blocks])):
            out[path] = from_buckets(qb, n, tuple(leaf.shape)).to(leaf.dtype)
    return out


def _per_leaf_values(params, spec, bits_map, generator) -> Dict[str, torch.Tensor]:
    """Fake-quant values leaf by leaf through the plain pipeline (stochastic
    rounding draws each leaf's noise from ``generator`` in turn)."""
    return {
        p: uniform.fake_quant(
            x, _bits(p, spec, bits_map), bucket_size=spec.bucket_size,
            scaling=spec.scaling, stochastic=spec.stochastic, generator=generator,
        )
        for p, x in flax_leaves(params) if is_quantizable(p, x, spec)
    }


def _hard_values(params, spec, bits_map, generator) -> Dict[str, torch.Tensor]:
    values = _fused_fake_quant_values(params, spec, bits_map)
    return values if values is not None else _per_leaf_values(params, spec, bits_map, generator)


def ste_quantize_tree(
    params: Params,
    spec: QuantSpec,
    generator: Optional[torch.Generator] = None,
    bits_map: Optional[Dict[str, int]] = None,
) -> Dict[str, torch.Tensor]:
    """Uniform fake-quant of every quantizable leaf with a straight-through
    gradient: each touched parameter ``w`` becomes ``w + (q - w).detach()``.
    ``bits_map`` (flax path → bits) overrides ``spec.bits`` per leaf.
    Deterministic rounding takes one fake-quant launch per bits-group;
    stochastic rounding needs ``generator``."""
    if spec.method == "codebook":
        raise NotImplementedError(_CODEBOOKS)
    detached = {n: t.detach() for n, t in params.items()}
    values = _hard_values(detached, spec, bits_map, generator)
    q = map_quantizable(lambda p, _: values[p], detached, spec)
    return {
        n: t if q[n] is detached[n] else t + (q[n] - detached[n])  # value q, gradient 1
        for n, t in params.items()
    }


def quantize_tree_hard(
    params: Params,
    spec: QuantSpec,
    codebooks=None,
    bits_map: Optional[Dict[str, int]] = None,
) -> Dict[str, torch.Tensor]:
    """Quantize-dequantize values with no gradient path (deployment values;
    rounding is deterministic whatever ``spec.stochastic`` says, as in the
    JAX package)."""
    if spec.method == "codebook":
        raise NotImplementedError(_CODEBOOKS)
    detached = {n: t.detach() for n, t in params.items()}
    values = _hard_values(detached, spec.replace(stochastic=False), bits_map, None)
    return map_quantizable(lambda p, _: values[p], detached, spec)


def index_streams(params: Params, spec: QuantSpec, codebooks=None) -> Dict[str, np.ndarray]:
    """Quantization-level stream per quantizable leaf (flax path → int32
    levels, row-major, padding dropped), for Huffman size accounting."""
    if spec.method == "codebook":
        raise NotImplementedError(_CODEBOOKS)
    streams: Dict[str, np.ndarray] = {}
    for path, leaf in flax_leaves(params):
        if is_quantizable(path, leaf, spec):
            qt = uniform.quantize(leaf.detach(), spec.bits, bucket_size=spec.bucket_size,
                                  scaling=spec.scaling)
            streams[path] = qt.levels.reshape(-1)[: qt.n].cpu().numpy()
    return streams


def param_sizes(params: Params) -> Dict[str, int]:
    """Flax path → element count, for every leaf (for size reports)."""
    return {path: leaf.numel() for path, leaf in flax_leaves(params)}


def init_codebook_tree(params: Params, spec: QuantSpec, mode: str = "uniform"):
    raise NotImplementedError(_CODEBOOKS)


def ste_codebook_tree(params: Params, codebooks, spec: QuantSpec):
    raise NotImplementedError(_CODEBOOKS)
