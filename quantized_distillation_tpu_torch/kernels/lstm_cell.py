"""The LSTM cell's pointwise step after its recurrent product, one kernel
forward and one backward.

:func:`lstm_cell` ``(hw, bh, xw, c)`` → ``(c', h')`` for flax's
``OptimizedLSTMCell`` gates: ``z = (hw + bh) + xw`` with ``hw = h @ wh``
computed by the caller (``models/seq2seq.py::lstm_gates``), gate blocks i,
f, g, o of width W; ``c' = sigmoid(z_f) c + sigmoid(z_i) tanh(z_g)``,
``h' = sigmoid(z_o) tanh(c')``. ``hw`` and ``xw`` are [B, 4W] (``xw`` may be
a step of ``xw.unbind(1)``, a strided view of a [B, T, 4W] product), ``bh`` [4W], ``c``
[B, W]: on a tensor-parallel rank, its shards (W = H/m).

No TPU kernel is replaced (XLA fuses the JAX package's cell). On a CUDA
tensor the wrapper launches the kernels of ``csrc/lstm_cell.cu`` (see
:mod:`._build`; ``qdt_lstm_cell_forward`` and ``qdt_lstm_cell_backward``)
on PyTorch's current stream, f32 only, or raises: in place of the 11
elementwise kernels of the composite's forward and the 15 of its backward,
so a captured train step holds 2 nodes a cell step where it held ~26.
Under autograd the forward also writes the activated gates and ``tanh(c')``
([B, 5W]) for the backward, which returns ``dz`` [B, 4W] as the gradient of
``hw`` and of ``xw``, ``dz.sum(0)`` as the bias's and the gradient of ``c``;
an output that gets no gradient is read as zero (no fill kernel). Values
and gradients are the composite's bit for bit on the card (the kernel
repeats its f32 operations in their order).

A CPU tensor runs the composite, :func:`lstm_cell_reference`.
``lstm_cell.launches`` counts the forward kernel's launches,
``launches_backward`` the backward's.
"""

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# qdt_lstm_cell_forward(hw, s_hw, b, xw, s_xw, c, s_c, c_out, h_out, saved, rows, width, stream)
_FWD_ARGTYPES = [_P, _L, _P, _P, _L, _P, _L, _P, _P, _P, _I, _I, _P]
# qdt_lstm_cell_backward(dh, s_dh, dc, s_dc, saved, c, s_c, dz, dc_in, rows, width, stream)
_BWD_ARGTYPES = [_P, _L, _P, _L, _P, _P, _L, _P, _P, _I, _I, _P]


def lstm_cell_reference(hw, bh, xw, c):
    """The composite: PyTorch's elementwise operations on ``z = (hw + bh) +
    xw`` → ``(c', h')``."""
    z = (hw + bh) + xw
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
    return c, torch.sigmoid(zo) * torch.tanh(c)


def _check(hw, bh, xw, c) -> None:
    b, width = c.shape[0], c.shape[-1]
    if not (c.dim() == 2 and hw.shape == (b, 4 * width) and xw.shape == (b, 4 * width)
            and bh.shape == (4 * width,)):
        raise ValueError(f"hw, xw [B, 4W], bh [4W], c [B, W] expected, got {tuple(hw.shape)}, "
                         f"{tuple(xw.shape)}, {tuple(bh.shape)}, {tuple(c.shape)}")
    for t in (hw, bh, xw):
        if t.device != c.device:
            raise ValueError(f"a tensor is on {t.device}, not {c.device}")
        if t.dtype != c.dtype:
            raise ValueError(f"mixed dtypes {t.dtype} and {c.dtype}")


def _rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` itself where its rows are unit-stride (the kernels take a row
    stride), else a contiguous copy."""
    if t is None or t.stride(-1) == 1:
        return t
    return t.contiguous()


def _stride(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.stride(0)


def _forward(hw, bh, xw, c, save: bool):
    """Launch the forward kernel → (c', h', the saved [B, 5W] or None)."""
    hw, bh, xw, c = _rows(hw), bh.contiguous(), _rows(xw), _rows(c)
    b, width = c.shape
    c_new, h_new = c.new_empty((b, width)), c.new_empty((b, width))
    saved = c.new_empty((b, 5 * width)) if save else None
    if b * width:
        fn = _build.function("lstm_cell", "qdt_lstm_cell_forward", _FWD_ARGTYPES)
        with _build.on(c.device):
            err = fn(_build.ptr(hw), _stride(hw), _build.ptr(bh), _build.ptr(xw), _stride(xw),
                     _build.ptr(c), _stride(c), _build.ptr(c_new), _build.ptr(h_new),
                     _build.ptr(saved), b, width, _build.stream())
        _build.check(err, "lstm_cell")
        lstm_cell.launches += 1
    return c_new, h_new, saved


def _backward(dh, dc_new, saved, c, need_dc: bool):
    """Launch the backward kernel → (dz [B, 4W], dc [B, W] or None)."""
    dh, dc_new, c = _rows(dh), _rows(dc_new), _rows(c)
    b, width = c.shape
    dz = c.new_empty((b, 4 * width))
    dc = c.new_empty((b, width)) if need_dc else None
    if b * width:
        fn = _build.function("lstm_cell", "qdt_lstm_cell_backward", _BWD_ARGTYPES)
        with _build.on(c.device):
            err = fn(_build.ptr(dh), _stride(dh), _build.ptr(dc_new), _stride(dc_new),
                     _build.ptr(saved), _build.ptr(c), _stride(c), _build.ptr(dz),
                     _build.ptr(dc), b, width, _build.stream())
        _build.check(err, "lstm_cell backward")
        lstm_cell.launches_backward += 1
    return dz, dc


class _LSTMCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hw, bh, xw, c):
        ctx.set_materialize_grads(False)  # an output without a gradient reads as zero
        c_new, h_new, saved = _forward(hw, bh, xw, c, save=True)
        ctx.save_for_backward(saved, c)
        return c_new, h_new

    @staticmethod
    def backward(ctx, dc_new, dh_new):
        need_hw, need_bh, need_xw, need_c = ctx.needs_input_grad
        saved, c = ctx.saved_tensors
        dz, dc = _backward(dh_new, dc_new, saved, c, need_c)
        return (dz if need_hw else None, dz.sum(0) if need_bh else None,
                dz if need_xw else None, dc)


def lstm_cell(hw: torch.Tensor, bh: torch.Tensor, xw: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(c', h')`` of the cell on ``z = (hw + bh) + xw`` (see the module
    docstring); differentiable in all four inputs."""
    _check(hw, bh, xw, c)
    if c.device.type == "cpu":
        return lstm_cell_reference(hw, bh, xw, c)
    if c.device.type != "cuda":
        raise ValueError(f"unsupported device {c.device}")
    if c.dtype != torch.float32:
        raise ValueError(f"the LSTM cell kernels take f32, got {c.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (hw, bh, xw, c)):
        return _LSTMCell.apply(hw, bh, xw, c)
    return _forward(hw, bh, xw, c, save=False)[:2]


lstm_cell.launches = 0
lstm_cell.launches_backward = 0
