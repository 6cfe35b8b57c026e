"""Uniform bucketed fake-quantization with a straight-through estimator
(PyTorch port of the JAX package's ``ops/uniform.py``).

Bucket the flattened tensor (256 per bucket), scale each bucket into
[0, 1], snap to the grid ``k / s`` with ``s = 2^bits - 1`` (round half to
even, or stochastic rounding), and scale back.

:func:`fake_quant` sends deterministic rounding of a CUDA tensor to the
hand-written kernel (:func:`..kernels.fake_quant.fake_quant_buckets`, one
read and one write of the weights) and everything else through the plain
pipeline here. Stochastic rounding stays on the plain pipeline on every
device, as in the JAX package: its kernel has no stochastic mode.

:func:`ste_fake_quant` needs no ``torch.autograd.Function``: the value is
``q(x)``, the gradient the identity, written ``x + (q - x).detach()`` with
``q`` computed from ``x.detach()`` (the JAX package's
``x + stop_gradient(q - x)``), and the kernel has no backward of its own.
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


class QuantizedTensor(NamedTuple):
    """Integer levels in ``[0, 2^bits - 1]`` (int32 ``[n_buckets,
    bucket_size]``) plus the per-bucket scaling."""

    levels: torch.Tensor
    scale: ScaleParams
    bits: int
    shape: Tuple[int, ...]
    n: int  # real (non-padding) elements


def quantize_levels_01(
    x01: torch.Tensor,
    bits: int,
    *,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Scaled values in [0, 1] → integer levels in [0, 2^bits - 1].

    Deterministic: round half to even, as ``jnp.round`` does (``torch.round``
    matches it, ``floor(x + 0.5)`` would not). Stochastic: ``floor(v·s + u)``
    with ``u ~ U[0, 1)`` drawn from ``generator`` (on ``x01``'s device),
    which is unbiased."""
    s = (1 << bits) - 1
    v = x01 * s
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding requires a torch.Generator")
        u = torch.rand(v.shape, generator=generator, dtype=v.dtype, device=v.device)
        q = torch.floor(v + u)
    else:
        q = torch.round(v)
    return torch.clamp(q, 0, s).to(torch.int32)


def dequantize_levels_01(levels: torch.Tensor, bits: int, dtype=torch.float32) -> torch.Tensor:
    """Integer levels → grid values in [0, 1]."""
    s = (1 << bits) - 1
    return levels.to(dtype) * (1.0 / s)


def quantize(
    x: torch.Tensor,
    bits: int,
    *,
    bucket_size: int = DEFAULT_BUCKET_SIZE,
    scaling: str = LINEAR,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> QuantizedTensor:
    """Tensor → integer levels + bucket scales."""
    buckets, n = to_buckets(x, bucket_size)
    sp = compute_scale(buckets, scaling)
    levels = quantize_levels_01(
        apply_scale(buckets, sp), bits, stochastic=stochastic, generator=generator
    )
    return QuantizedTensor(levels=levels, scale=sp, bits=bits, shape=tuple(x.shape), n=n)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Levels + scales → the fake-quantized tensor in its original shape."""
    buckets = invert_scale(dequantize_levels_01(qt.levels, qt.bits, dtype), qt.scale)
    return from_buckets(buckets, qt.n, qt.shape).to(dtype)


def fake_quant(
    x: torch.Tensor,
    bits: int,
    *,
    bucket_size: int = DEFAULT_BUCKET_SIZE,
    scaling: str = LINEAR,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Quantize-dequantize round trip, no gradient of its own (the input
    is detached). Deterministic rounding of a CUDA tensor whose bucket size
    is a multiple of 128 runs the fake-quant kernel."""
    x = x.detach()
    if x.device.type == "cuda" and not stochastic and bucket_size % 128 == 0:
        from ..kernels.fake_quant import fake_quant_buckets

        buckets, n = to_buckets(x.to(torch.float32), bucket_size)
        out = fake_quant_buckets(buckets.contiguous(), bits, scaling=scaling)
        return from_buckets(out, n, tuple(x.shape)).to(x.dtype)
    return dequantize(
        quantize(x, bits, bucket_size=bucket_size, scaling=scaling,
                 stochastic=stochastic, generator=generator),
        dtype=x.dtype,
    )


def ste_fake_quant(
    x: torch.Tensor,
    bits: int,
    *,
    bucket_size: int = DEFAULT_BUCKET_SIZE,
    scaling: str = LINEAR,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Fake-quant with a straight-through gradient: value ``q(x)``,
    ``d out / d x`` the identity."""
    q = fake_quant(x, bits, bucket_size=bucket_size, scaling=scaling,
                   stochastic=stochastic, generator=generator)
    return x + (q - x).detach()
