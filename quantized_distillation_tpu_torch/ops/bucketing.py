"""Bucketed per-group scaling for weight quantization (PyTorch port of the
JAX package's ``ops/bucketing.py``).

A tensor is flattened and cut into buckets of ``bucket_size`` (256 in all
the paper's experiments); each bucket is scaled into [0, 1] on its own. The
flat tail is padded with the edge value so padding never changes a bucket's
min / max / abs-max.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

DEFAULT_BUCKET_SIZE = 256

LINEAR = "linear"
ABSMAX = "absmax"
_SCALINGS = (LINEAR, ABSMAX)


class ScaleParams(NamedTuple):
    """Per-bucket affine ``scaled = (x - offset) / scale`` ([n_buckets, 1])."""

    offset: torch.Tensor
    scale: torch.Tensor
    kind: str


def num_buckets(n: int, bucket_size: int = DEFAULT_BUCKET_SIZE) -> int:
    return -(-n // bucket_size)


def to_buckets(
    x: torch.Tensor, bucket_size: int = DEFAULT_BUCKET_SIZE
) -> Tuple[torch.Tensor, int]:
    """Flatten ``x`` to ``[n_buckets, bucket_size]`` (edge-padded tail);
    returns the buckets and the original element count."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = num_buckets(n, bucket_size) * bucket_size - n
    if pad:
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    return flat.reshape(-1, bucket_size), n


def compute_scale(buckets: torch.Tensor, kind: str = LINEAR) -> ScaleParams:
    """Per-bucket constants mapping each bucket into [0, 1]; a constant
    (or all-zero) bucket gets ``scale = 1``."""
    if kind not in _SCALINGS:
        raise ValueError(f"unknown scaling kind {kind!r}; expected one of {_SCALINGS}")
    if kind == LINEAR:
        lo = buckets.amin(dim=1, keepdim=True)
        hi = buckets.amax(dim=1, keepdim=True)
        rng = hi - lo
        scale = torch.where(rng > 0, rng, torch.ones_like(rng))
        return ScaleParams(offset=lo, scale=scale, kind=kind)
    amax = buckets.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, 2.0 * amax, torch.ones_like(amax))
    return ScaleParams(offset=-amax, scale=scale, kind=kind)


def from_buckets(buckets: torch.Tensor, n: int, shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`to_buckets`: strip the padding, restore ``shape``."""
    return buckets.reshape(-1)[:n].reshape(shape)


def apply_scale(buckets: torch.Tensor, sp: ScaleParams) -> torch.Tensor:
    """``[n_buckets, B]`` → scaled values in [0, 1]."""
    return (buckets - sp.offset) / sp.scale


def invert_scale(scaled01: torch.Tensor, sp: ScaleParams) -> torch.Tensor:
    """Inverse of :func:`apply_scale`."""
    return scaled01 * sp.scale + sp.offset


def floats_per_bucket(kind: str) -> int:
    """Scaling constants stored per bucket: min and max (linear) or the
    abs-max alone."""
    if kind not in _SCALINGS:
        raise ValueError(f"unknown scaling kind {kind!r}")
    return 2 if kind == LINEAR else 1
