"""The LSTM cell kernel's arithmetic, run on the CPU.

``lstm_cell_forward`` and ``lstm_cell_backward`` of ``csrc/lstm_cell.cu``
(the device functions between its "cell arithmetic" and "kernels" rules) are cut out of the source and compiled with ``g++
-ffp-contract=off`` against ``tests/lstm_cell_emulated.cpp``, which stands
in for CUDA's rounding intrinsics and, since the card's ``expf`` and
``tanhf`` are neither the host's libm nor the vectorized ones of PyTorch's
CPU build, for those two with the functions rounded from double.

Held against ``lstm_gates``' composite on random and saturating inputs (|z|
up to 40, |c| up to 50) at W = 650, the width of the kernel's scalar path:

- forward: each activation (sigmoid, tanh of z = ``(hw + bh) + xw``)
  within 2 ulps of the function's value rounded from double, as the
  composite's own are (PyTorch's CPU sigmoid is up to 2 ulps off, so the
  two may sit 4 apart: the host's library is not the card's); c' and h'
  bit-equal to the composite's multiplies and add over the kernel's own
  activations, tanh(c') within 2 ulps, as above;
- backward: fed the composite's own saved activations, dz and dc bit-equal
  to autograd's (no transcendental function is left: the same roundings in
  the same order, ``1 - y y`` as one FMA in PyTorch's tanh_backward as in
  the kernel), with both output gradients and with either absent.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.kernels import _build

HERE = Path(__file__).resolve().parent
ROWS, WIDTH = 64, 650
N = ROWS * WIDTH
ULPS = 2


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("lstm_cell")
    src = (_build.CSRC / "lstm_cell.cu").read_text()
    cut = src[src.index("// ---------------------------------------------------------- cell arithmetic"):
              src.index("// ------------------------------------------------------------------ kernels")]
    (out / "lstm_cell_math.inc").write_text(cut)
    exe = out / "lstm_cell_emulated"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", f"-I{out}",
                    str(HERE / "lstm_cell_emulated.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, text=True)
    return exe, out


def _run(emulated, mode, arrays, n_out):
    exe, out = emulated
    np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays]).tofile(out / "in.f32")
    subprocess.run([str(exe), mode, str(out / "in.f32"), str(N), str(out / "out.f32")],
                   check=True, timeout=120)
    return torch.from_numpy(np.fromfile(out / "out.f32", np.float32).reshape(n_out, ROWS, WIDTH))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in units in the last place of f32 (0 between -0 and +0)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _inputs(kind: str, seed: int):
    """hw, xw [B, 4W], bh [4W], c [B, W]."""
    g = torch.Generator().manual_seed(seed)
    if kind == "random":
        return (torch.randn(ROWS, 4 * WIDTH, generator=g), torch.randn(4 * WIDTH, generator=g),
                torch.randn(ROWS, 4 * WIDTH, generator=g), 2 * torch.randn(ROWS, WIDTH, generator=g))
    u = lambda *shape, lim: (2 * torch.rand(*shape, generator=g) - 1) * lim  # noqa: E731
    return u(ROWS, 4 * WIDTH, lim=20.0), u(4 * WIDTH, lim=1.0), u(ROWS, 4 * WIDTH, lim=20.0), \
        u(ROWS, WIDTH, lim=50.0)


def _gates(t: torch.Tensor):
    return [t[:, k * WIDTH:(k + 1) * WIDTH] for k in range(4)]


def _exact(fn, z: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(fn(z.double().numpy()).astype(np.float32))


def _sigmoid64(z):
    return 1.0 / (1.0 + np.exp(-z))


@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_forward_against_the_composite(emulated, kind):
    hw, bh, xw, c = _inputs(kind, seed=1 if kind == "random" else 2)
    z = (hw + bh) + xw
    assert float(z.abs().max()) > (30.0 if kind == "saturating" else 3.0)
    hw_g, xw_g = _gates(hw), _gates(xw)
    b_g = [bh[k * WIDTH:(k + 1) * WIDTH].expand(ROWS, WIDTH) for k in range(4)]
    i, f, g, o, c_new, tc, h = _run(emulated, "forward", [*hw_g, *b_g, *xw_g, c], 7)

    zi, zf, zg, zo = _gates(z)
    composite = [torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg), torch.sigmoid(zo)]
    exact = [_exact(_sigmoid64, zi), _exact(_sigmoid64, zf), _exact(np.tanh, zg),
             _exact(_sigmoid64, zo)]
    for name, got, want, theirs in zip("ifgo", (i, f, g, o), exact, composite):
        assert int(_ulps(got, want).max()) <= ULPS, f"gate {name}: the kernel's"
        assert int(_ulps(theirs, want).max()) <= ULPS, f"gate {name}: the composite's"
    assert torch.equal(c_new, f * c + i * g)
    assert int(_ulps(tc, _exact(np.tanh, c_new)).max()) <= ULPS
    assert int(_ulps(tc, torch.tanh(c_new)).max()) <= ULPS
    assert torch.equal(h, o * tc)


@pytest.mark.parametrize("kind", ["random", "saturating"])
@pytest.mark.parametrize("outputs", ["both", "h_only", "c_only"])
def test_backward_against_autograd(emulated, kind, outputs):
    hw, bh, xw, c = _inputs(kind, seed=3 if kind == "random" else 4)
    g = torch.Generator().manual_seed(5)
    dc = torch.randn(ROWS, WIDTH, generator=g) if outputs != "h_only" else None
    dh = torch.randn(ROWS, WIDTH, generator=g) if outputs != "c_only" else None
    hw_, c_ = hw.clone().requires_grad_(), c.clone().requires_grad_()
    zi, zf, zg, zo = ((hw_ + bh) + xw).chunk(4, dim=-1)
    si, sf, tg, so = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg), torch.sigmoid(zo)
    c_new = sf * c_ + si * tg
    tc = torch.tanh(c_new)
    h_new = so * tc
    sum((y * d).sum() for y, d in ((c_new, dc), (h_new, dh)) if d is not None).backward()

    zero = torch.zeros(ROWS, WIDTH)
    saved = [t.detach() for t in (si, sf, tg, so, tc)]
    got = _run(emulated, "backward", [*saved, c, dh if dh is not None else zero,
                                      dc if dc is not None else zero], 5)
    assert torch.equal(torch.cat(list(got[:4]), dim=-1), hw_.grad)
    assert torch.equal(got[4], c_.grad)
