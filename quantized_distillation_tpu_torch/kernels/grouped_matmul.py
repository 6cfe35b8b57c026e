"""Grouped matrix product over the experts a card holds: one product per
expert over that expert's contiguous rows, with the group offsets read on
the device.

The expert layer of ``models/deepseek_v2.py`` sorts its (token, expert)
pairs by expert, so the rows of each held expert lie side by side and the
pairs of experts held elsewhere form one discard group after them.
``offsets`` ([G + 1] int64 on the device) bounds the G held groups: group
``g`` is rows ``offsets[g]:offsets[g + 1]``, and rows from ``offsets[G]``
on are the discard group, which no kernel reads or writes.

:func:`grouped_matmul` ``(x, rows, w, offsets)`` → ``y`` [P, N]:
``y[p] = x[rows[p]] @ w[g]`` for every row ``p`` of a held group ``g``
and 0 in the discard group. ``rows`` ([P] int64) gathers the rows of
``x`` ([T, K]) inside the kernel, so the permuted activations are never
written out; ``rows=None`` takes ``x`` ([P, K]) as it lies. ``w`` is
[G, K, N]. Its backward is two more kernels: the data gradient is the
same kernel on ``dy`` and ``w`` transposed by strides (scattered back onto
``x``'s rows when ``rows`` gathered them), and the weight gradient
``dw[g] = x[rows_g]^T @ dy_g`` is a reduction over however many rows the
group has, looped inside each block.

No TPU kernel is replaced: the JAX package has no expert layer. On a CUDA
tensor the wrappers launch the hand-written kernels of
``csrc/grouped_matmul.cu`` (see :mod:`._build`; ``qdt_grouped_mm`` for
the forward and the data gradient, ``qdt_grouped_wgrad`` for the weight
gradient), f32 in and out on the CUDA cores (no TF32, as every train
configuration states), or raise. Every grid is sized for the worst case,
all P rows in one group, and each block finds its group and tile from
``offsets`` on the device: no host sync and no buffer of data-dependent
size, so the calls are captured in the train step's CUDA graph. The
kernels read float4s, so every width must be a multiple of 4; an operand
whose rows are not 16-byte aligned is copied first.

``covered`` (int64 [G] on the device, optional) counts the rows the
forward kernel writes per group, added by each row tile: held pairs that no
tile covers show as the difference from the group sizes.

A CPU tensor runs the plain version (:func:`grouped_matmul_reference`, a
loop over the groups). ``grouped_matmul.launches`` counts the product
kernel's launches (forward and data gradient), ``launches_wgrad`` the
weight gradient's.
"""

import ctypes
from typing import Optional

import torch

from . import _build

TILE = 128  # the kernels' output tile, rows and columns
MAX_GRID_Y = 65535  # grid.y holds the row tiles and one per group
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# qdt_grouped_mm(x, rows, w, out, offs, covered, G, depth, width, row_tiles,
#                sxm, swg, ldw, som, w_along, stream)
_MM_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I, _P]
# qdt_grouped_wgrad(x, rows, dy, dw, offs, G, K, N, sxm, sdm, sdg, sdk, stream)
_WGRAD_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _P]


def _check(x, rows, w, offsets, covered=None) -> None:
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x [T, K] and w [G, K, N] expected, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if offsets.shape != (w.shape[0] + 1,) or offsets.dtype != torch.int64:
        raise ValueError(f"offsets must be [G + 1] int64, got {tuple(offsets.shape)} "
                         f"{offsets.dtype}")
    if rows is not None and (rows.dim() != 1 or rows.dtype != torch.int64):
        raise ValueError("rows must be [P] int64")
    if covered is not None and (covered.shape != (w.shape[0],)
                                or covered.dtype != torch.int64):
        raise ValueError("covered must be [G] int64")
    extra = tuple(t for t in (rows, covered) if t is not None)
    for t in (x, w, offsets) + extra:
        if t.device != x.device:
            raise ValueError(f"a tensor is on {t.device}, not {x.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its rows are unit-stride, 16-byte aligned float4
    runs; else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % 4 == 0 for s in t.stride()[:-1]))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _widths(*ns) -> None:
    if any(n % 4 for n in ns):
        raise ValueError(f"the grouped kernels read float4s: widths {ns} must be multiples of 4")


def _launch_mm(x, rows, w, offsets, out, covered, transpose_w: bool) -> None:
    """``out[p] = x[rows[p]] @ w[g]`` (``w[g]^T`` with ``transpose_w``) for
    every row of a held group; the discard group's rows are left alone."""
    g = w.shape[0]
    depth, width = (w.shape[2], w.shape[1]) if transpose_w else (w.shape[1], w.shape[2])
    _widths(depth, width)
    row_tiles = (out.shape[0] + TILE - 1) // TILE
    if row_tiles + g > MAX_GRID_Y:
        raise ValueError(f"{out.shape[0]} rows over {g} groups exceed the grid")
    fn = _build.function("grouped_matmul", "qdt_grouped_mm", _MM_ARGTYPES)
    with _build.on(x.device):
        err = fn(_build.ptr(x), _build.ptr(rows), _build.ptr(w), _build.ptr(out),
                 _build.ptr(offsets), _build.ptr(covered), g, depth, width, row_tiles,
                 x.stride(0), w.stride(0), w.stride(1), out.stride(0), int(transpose_w),
                 _build.stream())
    _build.check(err, "grouped_matmul")
    grouped_matmul.launches += 1


def _launch_wgrad(x, rows, dy, offsets, dw) -> None:
    g, k, n = dw.shape
    _widths(k, n)
    fn = _build.function("grouped_matmul", "qdt_grouped_wgrad", _WGRAD_ARGTYPES)
    with _build.on(x.device):
        err = fn(_build.ptr(x), _build.ptr(rows), _build.ptr(dy), _build.ptr(dw),
                 _build.ptr(offsets), g, k, n, x.stride(0), dy.stride(0), dw.stride(0),
                 dw.stride(1), _build.stream())
    _build.check(err, "grouped_matmul wgrad")
    grouped_matmul.launches_wgrad += 1


def _groups(offsets: torch.Tensor):
    bounds = offsets.tolist()
    return list(zip(bounds[:-1], bounds[1:]))


def grouped_matmul_reference(x: torch.Tensor, rows: Optional[torch.Tensor], w: torch.Tensor,
                             offsets: torch.Tensor, n_rows: Optional[int] = None,
                             covered: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: a loop over the held groups (an empty group computes
    nothing); the discard group's rows are 0. ``n_rows`` (P) defaults to
    ``len(rows)``, or to ``x``'s rows without ``rows``; ``covered`` gets
    each group's rows added."""
    p = n_rows if n_rows is not None else (len(rows) if rows is not None else x.shape[0])
    out = x.new_zeros((p, w.shape[2]))
    for g, (s, e) in enumerate(_groups(offsets)):
        if e > s:
            src = x[rows[s:e]] if rows is not None else x[s:e]
            out[s:e] = src @ w[g]
            if covered is not None:
                covered[g] += e - s
    return out


def grouped_wgrad_reference(x, rows, dy, offsets, w_shape) -> torch.Tensor:
    """Plain version of the weight gradient: ``dw[g] = x[rows_g]^T @ dy_g``,
    0 for an empty group."""
    dw = dy.new_zeros(w_shape)
    for g, (s, e) in enumerate(_groups(offsets)):
        if e > s:
            src = x[rows[s:e]] if rows is not None else x[s:e]
            dw[g] = src.T @ dy[s:e]
    return dw


def _mm(x, rows, w, offsets, p, covered=None, transpose_w=False):
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, rows, w.transpose(1, 2) if transpose_w else w,
                                        offsets, p, covered)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("the grouped kernels take f32")
    n = w.shape[1] if transpose_w else w.shape[2]
    out = x.new_zeros((p, n))
    _launch_mm(_aligned(x), rows, _aligned(w), offsets, out, covered, transpose_w)
    return out


def _wgrad(x, rows, dy, offsets, w_shape):
    if x.device.type == "cpu":
        return grouped_wgrad_reference(x, rows, dy, offsets, w_shape)
    dw = dy.new_empty(w_shape)  # every group's tiles are written, an empty group's as 0
    _launch_wgrad(_aligned(x), rows, _aligned(dy), offsets, dw)
    return dw


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, w, offsets, p, covered):
        ctx.save_for_backward(x, rows, w, offsets)
        ctx.p = p
        return _mm(x, rows, w, offsets, p, covered)

    @staticmethod
    def backward(ctx, dy):
        x, rows, w, offsets = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxp = _mm(dy.contiguous(), None, w, offsets, dy.shape[0], transpose_w=True)
            dx = dxp if rows is None else x.new_zeros(x.shape).index_add_(0, rows, dxp)
        if ctx.needs_input_grad[2]:
            dw = _wgrad(x, rows, dy, offsets, w.shape)
        return dx, None, dw, None, None, None


def grouped_matmul(x: torch.Tensor, rows: Optional[torch.Tensor], w: torch.Tensor,
                   offsets: torch.Tensor, covered: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """``y[p] = x[rows[p]] @ w[g]`` over each held group ``g`` (rows
    ``offsets[g]:offsets[g + 1]``), 0 in the discard group; differentiable
    in ``x`` and ``w``; ``covered`` counts the rows written per group (see
    the module docstring)."""
    _check(x, rows, w, offsets, covered)
    p = len(rows) if rows is not None else x.shape[0]
    return _GroupedMatmul.apply(x, rows, w, offsets, p, covered)


grouped_matmul.launches = 0
grouped_matmul.launches_wgrad = 0
