"""Sub-byte bit-packing of quantization levels (PyTorch port of the JAX
package's ``ops/packing.py``).

Values are packed along the *last* axis, ``8 // bits`` values per byte,
value ``k`` in bits ``[k*bits, (k+1)*bits)`` (little-endian within the
byte): the layout of the ``.qdt`` artifact's and the native codec's
``pack_stream``. The serving kernels read another layout, the bit planes
of :mod:`..kernels.packed`; the two are not interchangeable.
"""

from __future__ import annotations

import torch


def values_per_byte(bits: int) -> int:
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8; got {bits}")
    return 8 // bits


def pack(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer levels in ``[0, 2^bits)`` into uint8 along the last
    axis, whose length must be a multiple of ``8 // bits``."""
    f = values_per_byte(bits)
    *lead, k = levels.shape
    if k % f:
        raise ValueError(f"last axis {k} not a multiple of {f} for {bits}-bit packing")
    v = levels.to(torch.uint8).reshape(*lead, k // f, f)
    packed = torch.zeros(v.shape[:-1], dtype=torch.uint8, device=levels.device)
    for i in range(f):
        packed |= v[..., i] << (i * bits)
    return packed


def unpack(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack`: uint8 → int32 levels, the last axis grows by
    ``8 // bits``."""
    f = values_per_byte(bits)
    mask = (1 << bits) - 1
    parts = [((packed >> (i * bits)) & mask).to(torch.int32) for i in range(f)]
    stacked = torch.stack(parts, dim=-1)
    *lead, k, _ = stacked.shape
    return stacked.reshape(*lead, k * f)
