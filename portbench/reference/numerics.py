"""The arithmetic the reference computes in.

Every product of the reference goes through :func:`mm`,
which rounds both operands to a format and multiplies in float32 with TF32
off. ``f32`` leaves them as they are: the reference proper. The lower
formats are the controls, the step below what a configuration states:

- ``tf32``: each operand rounded to nearest even on a 10-bit mantissa,
  what a TF32 tensor core reads of float32, products summed in float32
  (the control of a float32 configuration with TF32 off);
- ``fp8``: each operand scaled per tensor so that its largest magnitude is
  448, rounded to float8 e4m3 and scaled back, summed in float32 (the
  control of a bfloat16 configuration).

The rounding is written out, so a control reads the same on the CPU and on
the card.
"""

from __future__ import annotations

import torch

FORMATS = ("f32", "tf32", "fp8")
FP8_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in true float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` (float32) rounded to ``fmt`` and returned as float32."""
    if fmt == "f32":
        return x
    if fmt == "tf32":
        bits = x.contiguous().view(torch.int32)
        # round half to even on the 13 dropped mantissa bits
        lsb = (bits >> 13) & 1
        bits = (bits + 0x0FFF + lsb) & ~0x1FFF
        return bits.view(torch.float32)
    if fmt == "fp8":
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    raise ValueError(f"unknown format {fmt!r}; expected one of {FORMATS}")


class _Product(torch.autograd.Function):
    """``round(a) @ round(b)``, whose backward rounds the incoming gradient
    and the operands to the same format before its two products, as a
    lower-precision matmul's backward does. ``a`` may carry leading batch
    dims."""

    @staticmethod
    def forward(ctx, a, b, fmt):
        ra, rb = round_to(a, fmt), round_to(b, fmt)
        ctx.save_for_backward(ra, rb)
        ctx.fmt = fmt
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_to(g.contiguous(), ctx.fmt)
        ga, gb = rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg
        while gb.dim() > rb.dim():  # a batched input against one matrix
            gb = gb.sum(0)
        return ga, gb, None


def mm(a: torch.Tensor, b: torch.Tensor, fmt: str = "f32") -> torch.Tensor:
    """``a @ b`` with both operands (and, in the backward, the gradient) in
    ``fmt``, summed in float32. Batched when both are 3-D."""
    if fmt == "f32":
        return a @ b
    return _Product.apply(a, b, fmt)
