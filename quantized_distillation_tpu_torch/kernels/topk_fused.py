"""Fused generator: dequant + matmul + bias → per-row top-k and logsumexp.

PyTorch port of the JAX package's ``kernels/topk_fused.py``: the uniform
grid and, for a generator packed with a learned codebook (``p.points``
set), its LUT variant. :func:`dequant_matmul_topk` returns ``(values [M, k]
f32, indices [M, k] int32, lse [M, 1] f32)`` without writing the [M, N]
logits: on a CPU tensor through the plain version
:func:`dequant_matmul_topk_reference`, on a CUDA tensor through the
hand-written two-pass kernel ``csrc/topk_fused.cu`` (or raises): pass 1 on
the tensor cores at bf16 compute, on the CUDA cores at f32. Its plan (rows
per block, vocab tile, splits) comes from the CUDA library
(:func:`dequant_matmul_topk_plan`).
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
import functools
import math
from typing import Tuple

import torch

from . import _build
from .dequant_matmul import check_alignment, check_operands, dequant_matmul_reference
from .packed import BUCKET, PackedLinear

KMAX = 8
_P, _I = ctypes.c_void_p, ctypes.c_int
# qdt_topk_fused(x, x_bf16, compute_bf16, packed, scale, offset, points, bias,
#                M, K, N, npad, bits, k, tiles_per_split, splits, part_v,
#                part_i, part_m, part_s, out_v, out_i, out_lse, stream)
_ARGTYPES = [_P, _I, _I, _P, _P, _P, _P, _P] + [_I] * 8 + [_P] * 8
# qdt_topk_fused_plan(M, K, N, x_bf16, compute_bf16, lut, bits, plan[9])
_PLAN_ARGTYPES = [_I] * 7 + [ctypes.POINTER(ctypes.c_int)]
_PLAN_KEYS = ("BM", "BN", "stages", "tiles_per_split", "splits", "blocks", "smem_bytes",
              "blocks_per_sm", "x_resident")


def topk_sorted(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim in ``jax.lax.top_k``'s order: values
    descending, equal values by ascending index (what a stable descending
    sort of the row gives; NaN ranks first, -0.0 equals +0.0), without
    sorting the row: k rounds of ``argmax``, which returns the lowest index
    of the row's largest value (NaN counting as largest), each taking its
    pick out of a copy of the rows by writing -inf there. Once only -inf is
    left, a taken entry would look like an untaken one, so the lowest-index
    untaken -inf entry comes from a mask of the row's -inf entries."""
    k = min(k, x.shape[-1])
    left = x.to(torch.float32, copy=True)
    neg_inf = (x == -math.inf).view(torch.uint8)  # the -inf entries not yet taken
    picks = []
    for _ in range(k):
        pick = left.argmax(dim=-1, keepdim=True)
        first_neg_inf = neg_inf.argmax(dim=-1, keepdim=True)
        pick = torch.where(left.gather(-1, pick) == -math.inf, first_neg_inf, pick)
        left.scatter_(-1, pick, -math.inf)
        neg_inf.scatter_(-1, pick, 0)
        picks.append(pick)
    pos = torch.cat(picks, dim=-1)
    return x.gather(-1, pos), pos


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


@functools.lru_cache(maxsize=None)
def _plan(device: int, m: int, k: int, n: int, x_bf16: bool, compute_bf16: bool, lut: bool,
          bits: int) -> dict:
    """The plan of card ``device`` (it depends on that card's SM count and
    occupancy, so the cache is keyed by the device too)."""
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    fn = _build.function("topk_fused", "qdt_topk_fused_plan", _PLAN_ARGTYPES)
    with _build.on(device):
        err = fn(m, k, n, int(x_bf16), int(compute_bf16), int(lut), bits, plan)
    _build.check(err, "dequant_matmul_topk_plan")
    return dict(zip(_PLAN_KEYS, plan))


def dequant_matmul_topk_plan(
    x: torch.Tensor, p: PackedLinear, *, compute_dtype=torch.bfloat16
) -> dict:
    """The plan :func:`dequant_matmul_topk` launches for these operands, from
    the CUDA library (it depends on the card's SM count and occupancy): rows
    per block, columns per vocab tile, copy stages, vocab tiles per split,
    splits, pass-1 blocks, dynamic shared memory bytes, resident blocks per
    SM and whether x stays resident in shared memory."""
    return dict(_plan(x.device.index, x.shape[0], x.shape[1], p.shape[1],
                      x.dtype == torch.bfloat16, compute_dtype == torch.bfloat16,
                      p.points is not None, p.bits))


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
    if compute_dtype == torch.bfloat16:
        check_alignment(p)
    m, kk = x.shape
    n = p.shape[1]
    dev = x.device
    bias = p.bias if p.bias is not None else torch.zeros(n, dtype=torch.float32, device=dev)
    plan = _plan(dev.index, m, kk, n, x.dtype == torch.bfloat16,
                 compute_dtype == torch.bfloat16, p.points is not None, p.bits)
    tiles_per_split, splits = plan["tiles_per_split"], plan["splits"]
    part_v = torch.empty((m, splits, KMAX), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, splits, KMAX), dtype=torch.int32, device=dev)
    part_m = torch.empty((m, splits), dtype=torch.float32, device=dev)
    part_s = torch.empty((m, splits), dtype=torch.float32, device=dev)
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    lse = torch.empty((m, 1), dtype=torch.float32, device=dev)
    fn = _build.function("topk_fused", "qdt_topk_fused", _ARGTYPES)
    ptr = _build.ptr
    with _build.on(dev):
        err = fn(ptr(x), int(x.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
                 ptr(p.packed), ptr(p.scale), ptr(p.offset), ptr(p.points), ptr(bias), m, kk, n,
                 p.n_padded, p.bits, k, tiles_per_split, splits, ptr(part_v),
                 ptr(part_i), ptr(part_m), ptr(part_s), ptr(vals), ptr(idx), ptr(lse),
                 _build.stream())
    _build.check(err, "dequant_matmul_topk")
    if p.points is None:
        dequant_matmul_topk.launches += 1
    else:
        dequant_matmul_topk.launches_lut += 1
    return vals, idx, lse


dequant_matmul_topk.launches = 0
dequant_matmul_topk.launches_lut = 0
