"""Learned-codebook (non-uniform) bucketed quantization (PyTorch port of the
JAX package's ``ops/codebook.py``).

Each bucket-scaled weight in [0, 1] snaps to the nearest of ``s = 2^bits``
learned points; the value is differentiable in the point values, so the
codebook trains by gradient descent (differentiable quantization).

- :func:`nearest_point_idx` sorts the points (stably: trained points can
  collide) and binary-searches each weight, O(n log s) memory-free, with
  ties to the lower point; it returns the JAX package's integers exactly,
  for points in any order and outside [0, 1].
- The codebook gradient is the backward of the ``points[idx]`` gather: a
  scatter-add of each weight's cotangent, times its bucket's scale, into
  its point. :class:`PointGather` computes it as a histogram weighted by
  the cotangent: one row of ``2^bits`` sums a bucket (``scatter_add_``),
  then the rows summed. Autograd's own backward of ``points[idx]`` (an
  index-put with accumulation) sorts the indices and then sums each
  point's run of equal indices serially, about a hundred times slower on
  an H100 at the generator leaf's 8.2 M weights and 16 points
  (``chip_smoke.py`` times both); ``torch.bincount`` reads its largest
  index back to the host, which a captured train step cannot do. On a
  CUDA tensor the scatter adds with atomics in no fixed order, so it sums
  in f64 and rounds once to f32: the order then shows in the result only
  when an f64 sum lies within its rounding error of an f32 rounding
  boundary, so a codebook trains to the same points run after run on the
  card, and whatever is decoded with it repeats too.
- :func:`ste_fake_quant` is straight-through in the weights, as in
  :mod:`.uniform`: value ``fake_quant(x.detach(), points)``, gradient the
  identity in ``x``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .bucketing import (
    DEFAULT_BUCKET_SIZE,
    LINEAR,
    ScaleParams,
    apply_scale,
    compute_scale,
    from_buckets,
    invert_scale,
    to_buckets,
)


class CodebookQuantizedTensor(NamedTuple):
    """Indices into ``points`` (int64 ``[n_buckets, bucket_size]``) plus the
    bucket scales."""

    idx: torch.Tensor
    points: torch.Tensor  # [s] codebook in the scaled [0, 1] domain
    scale: ScaleParams
    shape: Tuple[int, ...]
    n: int  # real (non-padding) elements


def linspace01(s: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, s)`` in f32, bit for bit: ``i * f32(1 / (s - 1))``
    (XLA turns the division into that product) with the last point exactly
    1; ``torch.linspace`` rounds differently."""
    if s < 2:
        return torch.zeros(s, dtype=torch.float32, device=device)
    inv = torch.tensor(1.0, dtype=torch.float32) / (s - 1)
    steps = torch.arange(s - 1, dtype=torch.float32, device=device) * inv.item()
    return torch.cat([steps, torch.ones(1, dtype=torch.float32, device=device)])


def quantile_linear(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x.reshape(-1), qs)`` (linear interpolation) with its
    f32 arithmetic, by one sort: ``torch.quantile`` refuses inputs of more
    than 2^24 elements. XLA fuses the interpolation ``low * low_w + high *
    high_w`` into ``fma(high, high_w, low * low_w)``; the last product and
    the sum are taken in f64 here and rounded once, which gives its bits.
    (Rounded twice, two quantiles that fall on a run of equal weights, as
    a leaf's edge padding makes, came out one ulp apart and out of order,
    so codebook training moved the other of the two points.)"""
    a = torch.sort(x.reshape(-1).to(torch.float32)).values
    n = torch.tensor(a.numel(), dtype=torch.float32, device=a.device)
    q = qs.to(a.device, torch.float32) * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    low = torch.clamp(low, min=0, max=n - 1).long()
    high = torch.clamp(high, min=0, max=n - 1).long()
    return (a[high].double() * high_w.double() + (a[low] * low_w).double()).float()


def init_points(bits: int, mode: str = "uniform", x01: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """``2^bits`` points in the scaled [0, 1] domain: ``uniform`` is the
    uniform grid ``k / (s - 1)`` (differentiable quantization then starts at
    the uniform quantizer); ``quantile`` the empirical quantiles of the
    scaled weights ``x01`` (on ``x01``'s device)."""
    s = 1 << bits
    if mode == "uniform":
        return linspace01(s, device)
    if mode == "quantile":
        if x01 is None:
            raise ValueError("quantile init requires the scaled weights x01")
        return quantile_linear(x01, linspace01(s, x01.device))
    raise ValueError(f"unknown codebook init mode {mode!r}")


class PointGather(torch.autograd.Function):
    """``points[idx]``, differentiable in ``points``: the backward
    scatter-adds the cotangent into each point as a weighted histogram,
    summed in f64, a row of sums per bucket (``idx``'s first dimension)
    and then the rows."""

    @staticmethod
    def forward(ctx, points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n_points = points.shape[0]
        return points[idx]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        rows = idx.shape[0] if idx.dim() > 1 else 1
        g = grad.new_zeros((rows, ctx.n_points), dtype=torch.float64).scatter_add_(
            1, idx.reshape(rows, -1), grad.reshape(rows, -1).double())
        return g.sum(0).to(grad.dtype), None


def nearest_point_idx(x01: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Index (into ``points``) of the nearest point for each element, as
    int64; ties snap to the lower point. No gradient."""
    points, x01 = points.detach(), x01.detach().contiguous()
    order = torch.argsort(points, stable=True)
    sp = points[order]
    s = sp.shape[0]
    j = torch.searchsorted(sp, x01, side="left")  # sp[j-1] < x <= sp[j]
    hi = torch.clamp(j, 0, s - 1)
    lo = torch.clamp(j - 1, 0, s - 1)
    pick_lo = torch.abs(x01 - sp[lo]) <= torch.abs(sp[hi] - x01)
    return order[torch.where(pick_lo, lo, hi)]


def quantize(
    x: torch.Tensor,
    points: torch.Tensor,
    *,
    bucket_size: int = DEFAULT_BUCKET_SIZE,
    scaling: str = LINEAR,
) -> CodebookQuantizedTensor:
    """Tensor → nearest-point indices + bucket scales (no gradient path
    through the indices)."""
    buckets, n = to_buckets(x, bucket_size)
    sp = compute_scale(buckets, scaling)
    idx = nearest_point_idx(apply_scale(buckets, sp), points)
    return CodebookQuantizedTensor(idx=idx, points=points, scale=sp, shape=tuple(x.shape), n=n)


def dequantize(ct: CodebookQuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Indices + codebook + scales → tensor; differentiable in ``points``
    (the gather's backward scatter-adds into each point)."""
    buckets = invert_scale(PointGather.apply(ct.points, ct.idx), ct.scale)
    return from_buckets(buckets, ct.n, ct.shape).to(dtype)


def fake_quant(
    x: torch.Tensor,
    points: torch.Tensor,
    *,
    bucket_size: int = DEFAULT_BUCKET_SIZE,
    scaling: str = LINEAR,
) -> torch.Tensor:
    """Codebook quantize-dequantize round trip, differentiable in ``points``."""
    return dequantize(quantize(x, points, bucket_size=bucket_size, scaling=scaling),
                      dtype=x.dtype)


def ste_fake_quant(
    x: torch.Tensor,
    points: torch.Tensor,
    *,
    bucket_size: int = DEFAULT_BUCKET_SIZE,
    scaling: str = LINEAR,
) -> torch.Tensor:
    """Codebook fake-quant: value ``fake_quant(x.detach(), points)``,
    gradient the identity in ``x`` and the scatter-add in ``points``."""
    q = fake_quant(x.detach(), points, bucket_size=bucket_size, scaling=scaling)
    return q + (x - x.detach())
