"""Bucketed fake-quant: ``[n_buckets, bucket_size]`` f32 → the same shape,
each bucket scaled into [0, 1], snapped to the ``2^bits - 1`` grid and
scaled back.

PyTorch port of the JAX package's ``kernels/fake_quant.py``. The STE train
step fake-quantizes every quantizable weight of the student on every step
(``train/quantize_tree.py``): :func:`fake_quant_buckets` on a CPU tensor runs
the plain version :func:`fake_quant_buckets_reference`; on a CUDA tensor it
launches the hand-written kernel ``csrc/fake_quant.cu`` (or raises).
``fake_quant_buckets.launches`` counts kernel launches.

Both compute, per bucket, ``q = clip(round_half_even(((x - off) / scale)
* s), 0, s)`` and ``out = (q * f32(1/s)) * scale + off`` with every
operation rounded on its own (the kernel contracts nothing into an FMA),
so on one device the kernel equals its plain version bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.bucketing import _SCALINGS, ABSMAX, apply_scale, compute_scale, invert_scale
from ..ops.uniform import dequantize_levels_01, quantize_levels_01
from . import _build

LANES = 128  # bucket_size must be a multiple: 32 lanes x one float4 each
BITS = (2, 4, 8)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# qdt_fake_quant(x, out, n_buckets, bucket_size, s, inv_s, absmax, stream)
_ARGTYPES = [_P, _P, _I, _I, _F, _F, _I, _P]


def fake_quant_buckets_reference(
    buckets: torch.Tensor, bits: int, *, scaling: str = "linear"
) -> torch.Tensor:
    """Plain version: the bucketing pipeline of ``ops/uniform.py``."""
    sp = compute_scale(buckets, scaling)
    levels = quantize_levels_01(apply_scale(buckets, sp), bits)
    return invert_scale(dequantize_levels_01(levels, bits), sp)


def fake_quant_buckets(
    buckets: torch.Tensor, bits: int, *, scaling: str = "linear"
) -> torch.Tensor:
    """Fake-quantize every row (bucket) of ``buckets`` [n_buckets,
    bucket_size] f32 with its own min/max (``linear``) or abs-max scale."""
    if scaling not in _SCALINGS:
        raise ValueError(f"unknown scaling {scaling!r}; expected one of {_SCALINGS}")
    if buckets.dim() != 2:
        raise ValueError(f"buckets must be [n_buckets, bucket_size], got {tuple(buckets.shape)}")
    if buckets.device.type == "cpu":
        return fake_quant_buckets_reference(buckets, bits, scaling=scaling)
    if buckets.device.type != "cuda":
        raise ValueError(f"unsupported device {buckets.device}")
    nb, bs = buckets.shape
    if bs % LANES or bs == 0:
        raise ValueError(f"bucket_size {bs} must be a positive multiple of {LANES}")
    if bits not in BITS:
        raise ValueError(f"the fake-quant kernel takes bits in {BITS}, got {bits}")
    if buckets.dtype != torch.float32 or not buckets.is_contiguous():
        raise ValueError("buckets must be contiguous f32")
    if buckets.data_ptr() % 16:
        raise ValueError("buckets must start on a 16-byte boundary (float4 loads)")
    out = torch.empty_like(buckets)
    if nb == 0:
        return out
    s = (1 << bits) - 1
    fn = _build.function("fake_quant", "qdt_fake_quant", _ARGTYPES)
    with _build.on(buckets.device):
        err = fn(_build.ptr(buckets), _build.ptr(out), nb, bs, float(s), 1.0 / s,
                 int(scaling == ABSMAX), _build.stream())
    _build.check(err, "fake_quant_buckets")
    fake_quant_buckets.launches += 1
    return out


fake_quant_buckets.launches = 0
