"""The LSTM cell's pointwise step (``kernels/lstm_cell.py``).

On the CPU the wrapper runs the composite, which must be what
``lstm_gates`` computed before the kernel existed, bit for bit, in values
and in the gradients of all five of its inputs, at the cells' widths (256,
the teachers' 500 and 650) and a tensor-parallel shard's (64 of 256 over
4), on a strided per-step input, without autograd, and with an output that
gets no gradient. The autograd function that launches the kernels on the
card is driven here too, with its two C entry points played by PyTorch's
own elementwise operations over the same raw memory (pointers, row
strides, the saved [B, 5W] layout, ``dz``'s gate order, absent gradients):
it must equal the composite's autograd bit for bit.

Tests marked ``gpu`` hold the kernels to the composite on the card; they
skip where no card is visible.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.kernels import LAUNCH_COUNTERS, lstm_cell, lstm_cell_reference
from quantized_distillation_tpu_torch.models.seq2seq import lstm_gates
from quantized_distillation_tpu_torch.utils import tracing

cell_mod = importlib.import_module("quantized_distillation_tpu_torch.kernels.lstm_cell")

# (batch, hidden of h, width W of the cell's units): students, the nmt and LM
# teachers, a tensor-parallel shard (64 of 256 over 4: h whole, wh's columns)
SHAPES = [(8, 256, 256), (6, 500, 500), (5, 650, 650), (7, 256, 64)]
IDS = ["256", "500", "650", "shard64of256"]


def gates_before(wh, bh, c, h, xw):
    """``models/seq2seq.py::lstm_gates`` as it was written before the kernel."""
    z = (h @ wh + bh) + xw
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
    return c, torch.sigmoid(zo) * torch.tanh(c)


def _inputs(b, hidden, width, seed, steps=3, device="cpu"):
    """wh, bh, c, h and a [B, T, 4W] product whose slice [:, 1] is xw."""
    g = torch.Generator().manual_seed(seed)
    wh = torch.randn(hidden, 4 * width, generator=g) / hidden ** 0.5
    bh = torch.randn(4 * width, generator=g)
    c = 2 * torch.randn(b, width, generator=g)
    h = torch.randn(b, hidden, generator=g)
    xw_all = 2 * torch.randn(b, steps, 4 * width, generator=g)
    return [t.to(device) for t in (wh, bh, c, h, xw_all)]


def _grads(fn, inputs, dc, dh):
    """Outputs and the gradients of every input, ``dc``/``dh`` None where
    that output takes no part in the loss."""
    leaves = [t.clone().requires_grad_() for t in inputs]
    wh, bh, c, h, xw_all = leaves
    c_new, h_new = fn(wh, bh, c, h, xw_all[:, 1])
    terms = [(o * g).sum() for o, g in ((c_new, dc), (h_new, dh)) if g is not None]
    sum(terms).backward()
    return [c_new.detach(), h_new.detach()] + [t.grad for t in leaves]


def _same(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), i
        if a is not None:
            assert torch.equal(a, b), f"tensor {i} differs: max |diff| {(a - b).abs().max()}"


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("outputs", ["both", "h_only", "c_only"])
def test_cpu_branch_equals_the_composite_with_gradients(shape, outputs):
    inputs = _inputs(*shape, seed=sum(shape))
    g = torch.Generator().manual_seed(7)
    dc = torch.randn(shape[0], shape[2], generator=g) if outputs != "h_only" else None
    dh = torch.randn(shape[0], shape[2], generator=g) if outputs != "c_only" else None
    _same(_grads(lstm_gates, inputs, dc, dh), _grads(gates_before, inputs, dc, dh))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_cpu_branch_without_autograd(shape):
    wh, bh, c, h, xw_all = _inputs(*shape, seed=3)
    xw = xw_all[:, 2]
    assert not xw.is_contiguous()
    with torch.no_grad():
        got = lstm_gates(wh.requires_grad_(), bh, c, h, xw)
    assert all(t.grad_fn is None and not t.requires_grad for t in got)
    _same(list(got), list(gates_before(wh, bh, c, h, xw)))
    _same(list(lstm_cell(h @ wh, bh, xw, c)), list(lstm_cell_reference(h @ wh, bh, xw, c)))


def test_shapes_and_devices_are_checked():
    wh, bh, c, h, xw_all = _inputs(4, 8, 8, seed=1)
    with pytest.raises(ValueError, match=r"\[B, 4W\]"):
        lstm_cell(h @ wh, bh[:-1], xw_all[:, 0], c)
    with pytest.raises(ValueError, match="mixed dtypes"):
        lstm_cell((h @ wh).double(), bh, xw_all[:, 0], c)
    meta = [t.to("meta") for t in (h @ wh, bh, xw_all[:, 0], c)]
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cell(*meta)


def test_launch_counters_are_named():
    assert LAUNCH_COUNTERS["lstm_cell"] == (lstm_cell, "launches")
    assert LAUNCH_COUNTERS["lstm_cell_backward"] == (lstm_cell, "launches_backward")
    counts = tracing.counts()
    assert {"launch.lstm_cell", "launch.lstm_cell_backward"} <= counts.keys()


# ------------------------------------------------- the kernels' glue, emulated


def _view(ptr, rows, cols, stride):
    """[rows, cols] f32 over raw host memory at ``ptr`` with row ``stride``;
    None for a null pointer."""
    if not ptr.value:
        return None
    n = (rows - 1) * stride + cols
    arr = np.ctypeslib.as_array(ctypes.cast(ptr.value, ctypes.POINTER(ctypes.c_float)), (n,))
    return torch.from_numpy(arr).as_strided((rows, cols), (stride, 1))


def _emulated_forward(hw, s_hw, b, xw, s_xw, c, s_c, c_out, h_out, saved, rows, width, stream):
    w = width
    hw, xw = _view(hw, rows, 4 * w, s_hw), _view(xw, rows, 4 * w, s_xw)
    b, c = _view(b, 1, 4 * w, 4 * w)[0], _view(c, rows, w, s_c)
    zi, zf, zg, zo = ((hw + b) + xw).chunk(4, dim=-1)
    si, sf, tg, so = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg), torch.sigmoid(zo)
    cn = sf * c + si * tg
    tc = torch.tanh(cn)
    _view(c_out, rows, w, w).copy_(cn)
    _view(h_out, rows, w, w).copy_(so * tc)
    s = _view(saved, rows, 5 * w, 5 * w)
    if s is not None:
        s.copy_(torch.cat([si, sf, tg, so, tc], dim=-1))
    return 0


def _emulated_backward(dh, s_dh, dc, s_dc, saved, c, s_c, dz, dc_in, rows, width, stream):
    w = width
    si, sf, tg, so, tc = _view(saved, rows, 5 * w, 5 * w).chunk(5, dim=-1)
    c = _view(c, rows, w, s_c)
    zero = torch.zeros(rows, w)
    dh = _view(dh, rows, w, s_dh) if dh.value else zero
    dc = _view(dc, rows, w, s_dc) if dc.value else zero
    aten = torch.ops.aten
    dct = dc + aten.tanh_backward(dh * so, tc)
    parts = [aten.sigmoid_backward(dct * tg, si), aten.sigmoid_backward(dct * c, sf),
             aten.tanh_backward(dct * si, tg), aten.sigmoid_backward(dh * tc, so)]
    _view(dz, rows, 4 * w, 4 * w).copy_(torch.cat(parts, dim=-1))
    out = _view(dc_in, rows, w, w)
    if out is not None:
        out.copy_(dct * sf)
    return 0


@pytest.fixture
def emulated_kernels(monkeypatch):
    """The autograd function's launches go to the emulated entry points."""
    entry = {"qdt_lstm_cell_forward": _emulated_forward,
             "qdt_lstm_cell_backward": _emulated_backward}
    monkeypatch.setattr(cell_mod._build, "function", lambda lib, symbol, argtypes: entry[symbol])
    monkeypatch.setattr(cell_mod._build, "on", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(cell_mod._build, "stream", lambda: ctypes.c_void_p(0))


def _function_gates(wh, bh, c, h, xw):
    return cell_mod._LSTMCell.apply(h @ wh, bh, xw, c)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("outputs", ["both", "h_only", "c_only"])
def test_autograd_function_glue_equals_the_composite(emulated_kernels, shape, outputs):
    inputs = _inputs(*shape, seed=11 + sum(shape))
    g = torch.Generator().manual_seed(5)
    dc = torch.randn(shape[0], shape[2], generator=g) if outputs != "h_only" else None
    dh = torch.randn(shape[0], shape[2], generator=g) if outputs != "c_only" else None
    before = (lstm_cell.launches, lstm_cell.launches_backward)
    got = _grads(_function_gates, inputs, dc, dh)
    assert (lstm_cell.launches, lstm_cell.launches_backward) == (before[0] + 1, before[1] + 1)
    _same(got, _grads(gates_before, inputs, dc, dh))


def test_autograd_function_strided_gradients_and_state(emulated_kernels):
    """Outputs stacked over time (their gradients arrive as strided slices)
    and a carry that needs no gradient (the initial zeros)."""
    b, hidden, width, steps = 4, 256, 64, 3
    wh, bh, _, h0, xw_all = _inputs(b, hidden, width, seed=2, steps=steps)
    dy = torch.randn(b, steps, width, generator=torch.Generator().manual_seed(9))

    def run(step_fn):
        w, bias, x = (t.clone().requires_grad_() for t in (wh, bh, xw_all))
        c, h = torch.zeros(b, width), h0[:, :hidden]
        hs = []
        for t in range(steps):
            c, hn = step_fn(w, bias, c, h, x[:, t])
            hs.append(hn)
            h = torch.cat([hn] * (hidden // width), dim=-1)
        (torch.stack(hs, dim=1) * dy).sum().backward()
        return [torch.stack(hs, dim=1).detach(), w.grad, bias.grad, x.grad]

    _same(run(_function_gates), run(gates_before))


def test_forward_without_autograd_saves_nothing(emulated_kernels):
    wh, bh, c, h, xw_all = _inputs(3, 64, 64, seed=4)
    hw = h @ wh
    c_new, h_new, saved = cell_mod._forward(hw, bh, xw_all[:, 0], c, save=False)
    assert saved is None
    _same([c_new, h_new], list(lstm_cell_reference(hw, bh, xw_all[:, 0], c)))


# ------------------------------------------------------------------ on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("outputs", ["both", "h_only", "c_only"])
def test_gpu_kernels_equal_the_composite(cuda, shape, outputs):
    inputs = _inputs(*shape, seed=sum(shape), device=cuda)
    g = torch.Generator().manual_seed(7)
    dc = torch.randn(shape[0], shape[2], generator=g).to(cuda) if outputs != "h_only" else None
    dh = torch.randn(shape[0], shape[2], generator=g).to(cuda) if outputs != "c_only" else None
    before = (lstm_cell.launches, lstm_cell.launches_backward)
    got = _grads(lstm_gates, inputs, dc, dh)
    torch.cuda.synchronize()
    assert (lstm_cell.launches, lstm_cell.launches_backward) == (before[0] + 1, before[1] + 1)
    _same(got, _grads(gates_before, inputs, dc, dh))
