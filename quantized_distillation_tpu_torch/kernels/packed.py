"""Packed weight containers: the layout the serving kernels read.

PyTorch port of the JAX package's ``kernels/packed.py``; the bytes are the
same, so a matrix packed by either package is read by both.

- A weight matrix W[K, N] is bucketed along N in 256-column buckets.
- Within a bucket the levels are packed *planar*: byte ``i`` holds the
  levels of columns ``i, i + 256/f, ...`` (f = 8/bits values per byte,
  value ``t`` in bits ``[t*bits, (t+1)*bits)``).
- ``scale``/``offset`` are stored transposed, ``[N/256, K]`` f32, with the
  uniform grid's 1/(2^bits - 1) factor folded into ``scale``, so a weight
  is ``levels * scale + offset``.
- N is edge-padded to a whole number of bucket groups; ``shape`` keeps the
  logical (K, N).
- A learned codebook packed ``lut_mode="exact"`` stores each weight's
  nearest-point index as its level and the ``2^bits`` f32 points as a LUT
  (``points``), with the bucket scale unfolded: a weight is
  ``points[level] * scale + offset``. ``lut_mode="requant8"`` snaps the
  codebook values onto the uniform 8-bit grid and stores a uniform matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops.bucketing import LINEAR, compute_scale
from ..ops.codebook import nearest_point_idx
from ..ops.uniform import quantize_levels_01

BUCKET = 256
MAX_GROUP = 8
LUT_MODES = ("exact", "requant8")


@dataclasses.dataclass
class PackedLinear:
    """A [K, N] weight matrix in packed deployment form."""

    packed: torch.Tensor  # uint8 [K, Npad * bits // 8]
    scale: torch.Tensor  # f32 [Npad // 256, K]
    offset: torch.Tensor  # f32 [Npad // 256, K]
    bits: int  # container bits (unpack width)
    shape: Tuple[int, int]  # logical (K, N)
    group: int = 1  # buckets per grid step of the TPU kernels (fixes Npad)
    points: Optional[torch.Tensor] = None  # f32 [2^bits] codebook LUT (None = uniform)
    bias: Optional[torch.Tensor] = None  # f32 [N]
    quant_bits: Optional[int] = None  # grid bits when stored wider (store_bits=8)

    @property
    def effective_quant_bits(self) -> int:
        return self.quant_bits if self.quant_bits is not None else self.bits

    @property
    def n_padded(self) -> int:
        return self.scale.shape[0] * BUCKET

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def to(self, device) -> "PackedLinear":
        """The same matrix with every tensor on ``device``."""
        return dataclasses.replace(
            self,
            packed=self.packed.to(device),
            scale=self.scale.to(device),
            offset=self.offset.to(device),
            points=None if self.points is None else self.points.to(device),
            bias=None if self.bias is None else self.bias.to(device),
        )


def bucket_group(
    bits: int, n: Optional[int] = None, max_group: Optional[int] = None
) -> int:
    """Buckets per grid step of the TPU kernels. It fixes how far N is
    padded, and so the packed bytes, which is why the port keeps it."""
    bpb = BUCKET * bits // 8
    min_g = -(-128 // bpb)
    if n is None:
        return min_g
    nb = -(-n // BUCKET)
    return max(min_g, min(max_group or MAX_GROUP, nb))


def _pad_cols(w: torch.Tensor, bits: int, max_group: Optional[int] = None) -> torch.Tensor:
    n = w.shape[1]
    pad = (-n) % (BUCKET * bucket_group(bits, n, max_group))
    if pad:
        # edge-pad so padding never widens a bucket's min/max range
        w = torch.cat([w, w[:, -1:].expand(-1, pad)], dim=1)
    return w


def _plane_pack(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """[K, N] int levels → [K, N*bits/8] uint8 in planar-per-bucket layout."""
    k, n = levels.shape
    f = 8 // bits
    lv = levels.reshape(k, n // BUCKET, f, BUCKET // f).to(torch.uint8)
    packed = torch.zeros((k, n // BUCKET, BUCKET // f), dtype=torch.uint8, device=levels.device)
    for t in range(f):
        packed |= lv[:, :, t, :] << (t * bits)
    return packed.reshape(k, n // f)


def plane_unpack(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`_plane_pack` → [K, Npad] int32 levels."""
    k, nb = packed.shape
    f = 8 // bits
    mask = (1 << bits) - 1
    pb = packed.reshape(k, nb // (BUCKET // f), BUCKET // f)
    planes = [(pb >> (t * bits)) & mask for t in range(f)]
    return torch.stack(planes, dim=2).reshape(k, nb * f).to(torch.int32)


def pack_linear(
    w: torch.Tensor,
    bits: int,
    *,
    scaling: str = LINEAR,
    points: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    lut_mode: str = "exact",
    max_group: Optional[int] = None,
    store_bits: Optional[int] = None,
) -> PackedLinear:
    """Quantize a [K, N] f32 matrix and pack it: onto the uniform ``bits``
    grid, or, with ``points`` (``[2^bits]`` in the scaled domain), onto the
    nearest codebook point (see the module docstring for ``lut_mode``).

    ``store_bits=8`` (uniform only) keeps the ``bits``-level decisions but
    stores one level per byte (dequantized values are bit-identical to the
    sub-byte form). The tensors of the result live on ``w``'s device."""
    if w.ndim != 2:
        raise ValueError(f"pack_linear expects a matrix, got shape {tuple(w.shape)}")
    if lut_mode not in LUT_MODES:
        raise ValueError(f"lut_mode must be one of {LUT_MODES}, got {lut_mode!r}")
    sb = bits if store_bits is None else store_bits
    if sb != bits:
        if points is not None:
            raise ValueError(
                "store_bits applies to the uniform grid; codebooks use lut_mode='requant8'"
            )
        if sb != 8:
            raise ValueError(f"store_bits must be 8 (one level/byte), got {sb}")
    w = w.to(torch.float32)
    if points is not None:
        points = torch.as_tensor(points).detach().to(w.device, torch.float32)
    k, n = w.shape
    requant = points is not None and lut_mode == "requant8"
    if requant:
        sb = 8
    wp = _pad_cols(w, sb, max_group)
    buckets = wp.reshape(k * wp.shape[1] // BUCKET, BUCKET)
    sp = compute_scale(buckets, scaling)
    x01 = (buckets - sp.offset) / sp.scale
    if requant:  # the codebook values on the uniform 8-bit grid: a uniform matrix
        vals01 = torch.clamp(points[nearest_point_idx(x01, points)], 0.0, 1.0)
        levels = quantize_levels_01(vals01, 8)
        scale_eff = sp.scale / 255.0
        bits, points = 8, None
    elif points is not None:
        levels, scale_eff = nearest_point_idx(x01, points), sp.scale
    else:
        levels = quantize_levels_01(x01, bits)
        scale_eff = sp.scale / ((1 << bits) - 1)
    nb = wp.shape[1] // BUCKET
    return PackedLinear(
        packed=_plane_pack(levels.reshape(k, wp.shape[1]), sb),
        scale=scale_eff.reshape(k, nb).T.contiguous(),
        offset=sp.offset.reshape(k, nb).T.contiguous(),
        bits=sb,
        shape=(k, n),
        group=bucket_group(sb, n, max_group),
        points=None if points is None else points.contiguous(),
        bias=None if bias is None else bias.to(torch.float32).contiguous(),
        quant_bits=None if sb == bits else bits,
    )


def dequantize_linear(p: PackedLinear, dtype=torch.float32) -> torch.Tensor:
    """Packed → dense [K, N] weights (the plain versions' golden model):
    computed in f32, then cast to ``dtype``."""
    levels = plane_unpack(p.packed, p.bits)
    k, npad = levels.shape
    lv = levels.reshape(k, npad // BUCKET, BUCKET)
    vals = lv.to(torch.float32) if p.points is None else p.points[lv.long()]
    w = vals * p.scale.T[:, :, None] + p.offset.T[:, :, None]
    return w.reshape(k, npad)[:, : p.shape[1]].to(dtype)
