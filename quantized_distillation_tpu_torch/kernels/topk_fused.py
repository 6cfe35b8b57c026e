"""Fused generator: dequant + matmul + bias → per-row top-k and logsumexp.

PyTorch port of the JAX package's ``kernels/topk_fused.py``: the uniform
grid and, for a generator packed with a learned codebook (``p.points``
set), its LUT variant. :func:`dequant_matmul_topk` returns ``(values [M, k]
f32, indices [M, k] int32, lse [M, 1] f32)`` without writing the [M, N]
logits: on a CPU tensor through the plain version
:func:`dequant_matmul_topk_reference`, on a CUDA tensor through the
hand-written two-pass kernel ``csrc/topk_fused.cu`` (or raises).
``dequant_matmul_topk.launches`` counts launches of the uniform kernel,
``dequant_matmul_topk.launches_lut`` those of the LUT variant. Columns at
or past the logical width ``p.shape[1]`` never take part, whatever the
padding holds.

The port's top-k is exact for every input, with ``jax.lax.top_k``'s order
(values descending, equal values by ascending index). The TPU kernel's
approximate lane-class survivors and its latency knobs (``slots``,
``lse_shift``, ``fold``, ``pair``, ``select_dtype``, ``probe``) have no
counterpart here, and its exactness certificate, when asked for, is all
ones, as the JAX package's exact fallback returns.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .dequant_matmul import check_operands, dequant_matmul_reference
from .packed import BUCKET, PackedLinear

KMAX = 8
_BM, _BN = 64, 64  # the kernel's row and column tile (csrc/dequant_tile.cuh)
_TARGET_BLOCKS = 4 * 132  # a few waves of blocks on the H100's 132 SMs
_P, _I = ctypes.c_void_p, ctypes.c_int
# qdt_topk_fused(x, x_bf16, compute_bf16, packed, scale, offset, points, bias,
#                M, K, N, npad, bits, k, tiles_per_split, splits, part_v,
#                part_i, part_m, part_s, out_v, out_i, out_lse, stream)
_ARGTYPES = [_P, _I, _I, _P, _P, _P, _P, _P] + [_I] * 8 + [_P] * 8


def topk_sorted(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim in ``jax.lax.top_k``'s order: values
    descending, equal values by ascending index (a stable descending sort;
    bare ``torch.topk`` does not keep that order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pick_generator_group(
    rows: int, budget_bytes: int = 48 * 1024 * 1024, max_group: int = 32
) -> int:
    """The JAX package's buckets per grid step of the TPU generator kernel.
    The port keeps it because it fixes how far the vocab is padded, and so
    the packed bytes (B=256 → 1280 rows → 16 → V pads to 32768)."""
    rows_padded = -(-rows // 8) * 8
    group = max_group
    while group > 1 and rows_padded * (group + 16) * BUCKET * 4 > budget_bytes:
        group //= 2
    return group


def dequant_matmul_topk_reference(
    x: torch.Tensor, p: PackedLinear, k: int, *, compute_dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the plain dequant-matmul (+ bias; through the LUT
    when ``p.points`` is set), then exact top-k and lse."""
    logits = dequant_matmul_reference(x, p, compute_dtype=compute_dtype)
    vals, idx = topk_sorted(logits, k)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return vals, idx.to(torch.int32), lse


def split_plan(m: int, n: int) -> Tuple[int, int]:
    """(tiles_per_split, splits) of the vocab for pass 1: enough row-tile x
    split blocks to fill the card a few times over."""
    ntiles = -(-n // _BN)
    row_tiles = -(-m // _BM)
    splits = max(1, min(ntiles, -(-_TARGET_BLOCKS // row_tiles)))
    tiles_per_split = -(-ntiles // splits)
    return tiles_per_split, -(-ntiles // tiles_per_split)


def dequant_matmul_topk(
    x: torch.Tensor,
    p: PackedLinear,
    k: int,
    *,
    compute_dtype=torch.bfloat16,
    certify: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """x [M, K] @ dequant(p) [K, N] + bias → (top-k values [M, k] f32,
    indices [M, k] int32, logsumexp [M, 1] f32), plus an all-ones int32
    [M, 1] exactness certificate when ``certify``."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"fused top-k supports 1 <= k <= {KMAX}, got {k}")
    if k > p.shape[1]:
        raise ValueError(f"k={k} > vocab width {p.shape[1]}")
    if x.device.type == "cpu":
        out = dequant_matmul_topk_reference(x, p, k, compute_dtype=compute_dtype)
    elif x.device.type == "cuda":
        out = _launch(x, p, k, compute_dtype)
    else:
        raise ValueError(f"unsupported device {x.device}")
    if certify:
        out = out + (torch.ones((x.shape[0], 1), dtype=torch.int32, device=x.device),)
    return out


def _launch(x, p, k, compute_dtype):
    check_operands(x, p, compute_dtype)
    m, kk = x.shape
    n = p.shape[1]
    dev = x.device
    bias = p.bias if p.bias is not None else torch.zeros(n, dtype=torch.float32, device=dev)
    tiles_per_split, splits = split_plan(m, n)
    part_v = torch.empty((m, splits, KMAX), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, splits, KMAX), dtype=torch.int32, device=dev)
    part_m = torch.empty((m, splits), dtype=torch.float32, device=dev)
    part_s = torch.empty((m, splits), dtype=torch.float32, device=dev)
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    lse = torch.empty((m, 1), dtype=torch.float32, device=dev)
    fn = _build.function("topk_fused", "qdt_topk_fused", _ARGTYPES)
    ptr = _build.ptr
    _build.check(
        fn(ptr(x), int(x.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
           ptr(p.packed), ptr(p.scale), ptr(p.offset), ptr(p.points), ptr(bias), m, kk, n,
           p.n_padded, p.bits, k, tiles_per_split, splits, ptr(part_v),
           ptr(part_i), ptr(part_m), ptr(part_s), ptr(vals), ptr(idx), ptr(lse),
           _build.stream()),
        "dequant_matmul_topk",
    )
    if p.points is None:
        dequant_matmul_topk.launches += 1
    else:
        dequant_matmul_topk.launches_lut += 1
    return vals, idx, lse


dequant_matmul_topk.launches = 0
dequant_matmul_topk.launches_lut = 0
