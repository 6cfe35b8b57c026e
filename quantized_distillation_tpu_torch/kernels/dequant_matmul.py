"""Dequantize + matmul of packed weights: ``x [M, K] @ dequant(p) [K, N]``.

PyTorch port of the JAX package's ``kernels/dequant_matmul.py``: the
uniform grid and, for a matrix packed with a learned codebook
(``p.points`` set), its LUT variant. :func:`dequant_matmul` dispatches on
the device of ``x``: a CPU tensor runs the plain version
:func:`dequant_matmul_reference`, a CUDA tensor launches the hand-written
kernel ``csrc/dequant_matmul.cu`` (or raises): on the tensor cores at bf16
compute, on the CUDA cores at f32. ``dequant_matmul.launches`` counts
launches of the uniform kernel, ``dequant_matmul.launches_lut`` those of the
LUT variant.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .packed import PackedLinear, dequantize_linear

_COMPUTE = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# qdt_dequant_matmul(x, x_bf16, compute_bf16, packed, scale, offset, points,
#                    bias, out, M, K, N, npad, bits, stream)
_ARGTYPES = [_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
# qdt_dequant_matmul_plan(M, K, N, x_bf16, compute_bf16, lut, bits, plan[6])
_PLAN_ARGTYPES = [_I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
_PLAN_KEYS = ("BM", "BN", "stages", "blocks", "smem_bytes", "blocks_per_sm")
ALIGN = 16  # bytes: the TMA's alignment for the packed operands


def dequant_matmul_reference(
    x: torch.Tensor, p: PackedLinear, *, compute_dtype=torch.float32
) -> torch.Tensor:
    """Plain version: dense dequant in f32 (through the LUT when
    ``p.points`` is set), both operands rounded to ``compute_dtype``,
    products summed in f32 (+ bias) → f32 [M, N]."""
    w = dequantize_linear(p, dtype=compute_dtype).to(torch.float32)
    out = x.to(compute_dtype).to(torch.float32) @ w
    if p.bias is not None:
        out = out + p.bias
    return out


def check_operands(x: torch.Tensor, p: PackedLinear, compute_dtype) -> None:
    """Validate what the packed-weight kernels take (shared with the fused
    generator kernel)."""
    if compute_dtype not in _COMPUTE:
        raise ValueError(f"compute_dtype must be f32 or bf16, got {compute_dtype}")
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] != p.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match packed K={p.shape[0]}")
    if x.dtype not in _COMPUTE:
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    if p.bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {p.bits}")
    tensors = [x, p.packed, p.scale, p.offset] + [t for t in (p.points, p.bias) if t is not None]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    if p.packed.dtype != torch.uint8 or p.scale.dtype != torch.float32:
        raise ValueError("packed must be uint8 and scale/offset f32")
    if p.bias is not None and tuple(p.bias.shape) != (p.shape[1],):
        raise ValueError(f"bias must be [{p.shape[1]}], got {tuple(p.bias.shape)}")
    if p.points is not None and (p.points.dtype != torch.float32
                                 or tuple(p.points.shape) != (1 << p.bits,)):
        raise ValueError(f"points must be f32 [{1 << p.bits}], got {p.points.dtype} "
                         f"{tuple(p.points.shape)}")


def check_alignment(p: PackedLinear) -> None:
    """The tensor-core kernel (bf16 compute) copies the packed bytes, scale
    and offset with the TMA, which needs 16-byte aligned bases (their rows,
    npad·bits/8 bytes, are then aligned too). ``pack_linear``'s tensors
    always are; a view into a larger buffer may not be. x may have any
    alignment: where it rules the TMA out, the kernel's threads copy every
    operand themselves."""
    for name in ("packed", "scale", "offset"):
        if getattr(p, name).data_ptr() % ALIGN:
            raise ValueError(f"{name} must be {ALIGN}-byte aligned for bf16 compute "
                             f"(address {getattr(p, name).data_ptr():#x})")


def dequant_matmul_plan(x: torch.Tensor, p: PackedLinear, *, compute_dtype=torch.bfloat16) -> dict:
    """The tile plan :func:`dequant_matmul` launches for these operands, from
    the CUDA library (it depends on the card's SM count): rows and columns
    per tile, copy stages, blocks, dynamic shared memory bytes and resident
    blocks per SM."""
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    fn = _build.function("dequant_matmul", "qdt_dequant_matmul_plan", _PLAN_ARGTYPES)
    with _build.on(x.device):
        err = fn(x.shape[0], x.shape[1], p.shape[1], int(x.dtype == torch.bfloat16),
                 int(compute_dtype == torch.bfloat16), int(p.points is not None), p.bits, plan)
    _build.check(err, "dequant_matmul_plan")
    return dict(zip(_PLAN_KEYS, plan))


def dequant_matmul(
    x: torch.Tensor, p: PackedLinear, *, compute_dtype=torch.bfloat16
) -> torch.Tensor:
    """x [M, K] (f32 or bf16) @ dequant(p) [K, N] (+ bias) → f32 [M, N]."""
    if x.device.type == "cpu":
        return dequant_matmul_reference(x, p, compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check_operands(x, p, compute_dtype)
    if compute_dtype == torch.bfloat16:
        check_alignment(p)
    m, k = x.shape
    n = p.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("dequant_matmul", "qdt_dequant_matmul", _ARGTYPES)
    with _build.on(x.device):
        err = fn(_build.ptr(x), int(x.dtype == torch.bfloat16),
                 int(compute_dtype == torch.bfloat16), _build.ptr(p.packed),
                 _build.ptr(p.scale), _build.ptr(p.offset), _build.ptr(p.points),
                 _build.ptr(p.bias), _build.ptr(out), m, k, n, p.n_padded, p.bits,
                 _build.stream())
    _build.check(err, "dequant_matmul")
    if p.points is None:
        dequant_matmul.launches += 1
    else:
        dequant_matmul.launches_lut += 1
    return out


dequant_matmul.launches = 0
dequant_matmul.launches_lut = 0
