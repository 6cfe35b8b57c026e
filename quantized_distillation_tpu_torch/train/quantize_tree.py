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
substring in the path; biases stay full precision.

Under tensor parallelism (:func:`ste_quantize_tree_tp`) a rank holds only
its shard of each split leaf, and a split cuts buckets (a 256-wide gate
row spans the ranks at H/m = 128; the generator's 32,000-wide rows split
mid-bucket), so the split quantizable parameters are all-gathered over
``model`` in one flat buffer, fake-quantized whole exactly as the
one-process step does (one kernel launch per bits-group over the whole
tree), and each rank keeps its slice: the values are bit-identical to the
one-process step's.

Differentiable quantization (``QuantSpec(method="codebook")``) keeps one
learned codebook of ``2^bits`` points per quantizable leaf, in a flat dict
keyed by flax path (:func:`init_codebook_tree`); :func:`ste_codebook_tree`
fake-quantizes each leaf onto its codebook, straight-through in the weights
and differentiable in the points. Its ops run leaf by leaf, eagerly (the
JAX package compiles them into the step): a few hundred small launches per
step, which the train step's stage breakdown reports as the codebook tree.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import QuantSpec
from ..convert import flax_leaves, flax_paths, fuse_flax_leaves
from ..kernels.fake_quant import fake_quant_buckets
from ..ops import codebook as cb
from ..ops import uniform
from ..ops.bucketing import apply_scale, compute_scale, from_buckets, to_buckets
from ..parallel.tensor import copy_to_model

Params = Mapping[str, torch.Tensor]
Codebooks = Dict[str, torch.Tensor]


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
    stochastic rounding needs ``generator``. (Learned codebooks go through
    :func:`ste_codebook_tree`.)"""
    detached = {n: t.detach() for n, t in params.items()}
    values = _hard_values(detached, spec, bits_map, generator)
    q = map_quantizable(lambda p, _: values[p], detached, spec)
    return {
        n: t if q[n] is detached[n] else t + (q[n] - detached[n])  # value q, gradient 1
        for n, t in params.items()
    }


def ste_quantize_tree_tp(
    params: Params,
    spec: QuantSpec,
    model_parallel,
    generator: Optional[torch.Generator] = None,
    bits_map: Optional[Dict[str, int]] = None,
) -> Dict[str, torch.Tensor]:
    """:func:`ste_quantize_tree` of this rank's shards ``params`` (name →
    local tensor; ``model_parallel`` a ``parallel.tensor.ModelParallel``
    holding their specs): the split parameters with a quantizable leaf
    are gathered whole over ``model`` (one all-gather), the whole tree is
    fake-quantized, and each parameter's value is the rank's slice of it,
    with a straight-through gradient to the local master shard."""
    mp = model_parallel
    detached = {n: t.detach() for n, t in params.items()}
    whole = _whole_quantizable(params, spec, mp)
    values = _hard_values(whole, spec, bits_map, generator)
    q = map_quantizable(lambda p, _: values[p], whole, spec)
    out = {}
    for n, t in params.items():
        if q[n] is whole[n]:
            out[n] = t
        else:
            out[n] = t + (mp.local(n, q[n]) - detached[n])  # value q's slice, gradient 1
    return out


def _whole_quantizable(params: Params, spec: QuantSpec, mp) -> Dict[str, torch.Tensor]:
    """The detached parameters with every split one that holds a
    quantizable leaf gathered whole (one all-gather over ``model``)."""
    detached = {n: t.detach() for n, t in params.items()}
    quantizable = {n: t for n, t in detached.items()
                   if any(is_quantizable(p, x, spec) for p, x in flax_leaves({n: t}))}
    return {**detached, **mp.gather(quantizable)}


def quantize_tree_hard(
    params: Params,
    spec: QuantSpec,
    codebooks: Optional[Codebooks] = None,
    bits_map: Optional[Dict[str, int]] = None,
) -> Dict[str, torch.Tensor]:
    """Quantize-dequantize values with no gradient path (deployment values;
    rounding is deterministic whatever ``spec.stochastic`` says, as in the
    JAX package). ``spec.method == "codebook"`` snaps each leaf onto its
    codebook in ``codebooks``."""
    detached = {n: t.detach() for n, t in params.items()}
    if spec.method == "codebook":
        if codebooks is None:
            raise ValueError("codebook method requires codebooks")
        return map_quantizable(
            lambda p, w: cb.fake_quant(w, codebooks[p].detach(), bucket_size=spec.bucket_size,
                                       scaling=spec.scaling),
            detached, spec,
        )
    values = _hard_values(detached, spec.replace(stochastic=False), bits_map, None)
    return map_quantizable(lambda p, _: values[p], detached, spec)


def index_streams(
    params: Params, spec: QuantSpec, codebooks: Optional[Codebooks] = None
) -> Dict[str, np.ndarray]:
    """Quantization-level stream per quantizable leaf (flax path → int32
    levels, or codebook indices when ``spec.method == "codebook"`` and
    ``codebooks`` are given; row-major, padding dropped), for Huffman size
    accounting."""
    streams: Dict[str, np.ndarray] = {}
    for path, leaf in flax_leaves(params):
        if is_quantizable(path, leaf, spec):
            leaf = leaf.detach()
            if spec.method == "codebook" and codebooks is not None:
                ct = cb.quantize(leaf, codebooks[path], bucket_size=spec.bucket_size,
                                 scaling=spec.scaling)
                idx, n = ct.idx, ct.n
            else:
                qt = uniform.quantize(leaf, spec.bits, bucket_size=spec.bucket_size,
                                      scaling=spec.scaling)
                idx, n = qt.levels, qt.n
            streams[path] = idx.reshape(-1)[:n].to(torch.int32).cpu().numpy()
    return streams


def param_sizes(params: Params) -> Dict[str, int]:
    """Flax path → element count, for every leaf (for size reports)."""
    return {path: leaf.numel() for path, leaf in flax_leaves(params)}


def init_codebook_tree(params: Params, spec: QuantSpec, mode: str = "uniform",
                       model_parallel=None) -> Codebooks:
    """One codebook of ``2^spec.bits`` f32 points per quantizable leaf, keyed
    by flax path, on the leaf's device: the uniform grid, or (``quantile``)
    the quantiles of the leaf's bucket-scaled weights, the last bucket's
    edge padding included, as the JAX package computes them. With
    ``model_parallel`` the parameters are one rank's shards, and the
    quantiles are the whole leaves' (gathered)."""
    if model_parallel is not None and mode == "quantile":
        params = _whole_quantizable(params, spec, model_parallel)
    books: Codebooks = {}
    for path, leaf in flax_leaves(params):
        if not is_quantizable(path, leaf, spec):
            continue
        x01 = None
        if mode == "quantile":
            b, _ = to_buckets(leaf.detach(), spec.bucket_size)
            x01 = apply_scale(b, compute_scale(b, spec.scaling))
        books[path] = cb.init_points(spec.bits, mode, x01, device=leaf.device)
    return books


def ste_codebook_tree_tp(params: Params, codebooks: Codebooks, spec: QuantSpec,
                         model_parallel) -> Dict[str, torch.Tensor]:
    """:func:`ste_codebook_tree` of this rank's shards ``params``: every
    split leaf is snapped onto its codebook whole (gathered, so its buckets
    are the one-process step's) and the rank keeps its slice; the value's
    gradient goes straight through to the local shard, and into the points
    through each rank's own weights, summed over ``model``."""
    mp = model_parallel
    whole = _whole_quantizable(params, spec, mp)
    split = {p for n in params if mp.is_split(n) for p in flax_paths(n)}
    q = map_quantizable(
        lambda p, x: cb.fake_quant(
            x, copy_to_model(codebooks[p], mp) if p in split else codebooks[p],
            bucket_size=spec.bucket_size, scaling=spec.scaling),
        whole, spec)
    return {
        n: t if q[n] is whole[n] else mp.local(n, q[n]) + (t - t.detach())
        for n, t in params.items()
    }


def ste_codebook_tree(params: Params, codebooks: Codebooks, spec: QuantSpec) -> Dict[str, torch.Tensor]:
    """Codebook fake-quant of every quantizable leaf: value the leaf snapped
    onto its codebook, gradient straight through to the weights and
    scatter-added into the points, so the same transform serves joint
    training and frozen-weight differentiable quantization."""
    return map_quantizable(
        lambda p, x: cb.ste_fake_quant(x, codebooks[p], bucket_size=spec.bucket_size,
                                       scaling=spec.scaling),
        params, spec,
    )
