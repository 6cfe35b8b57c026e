"""Packed weight format, the three hand-written serving kernels and the
fake-quant kernel of the train step.

Each kernel wrapper dispatches on its input's device: a CPU tensor runs the
plain PyTorch version beside it, a CUDA tensor launches the CUDA kernel
built from ``csrc/`` (see :mod:`._build`) or raises.
"""

from .beam_combine import beam_combine_topk, beam_combine_topk_reference
from .dequant_matmul import dequant_matmul, dequant_matmul_plan, dequant_matmul_reference
from .fake_quant import fake_quant_buckets, fake_quant_buckets_reference
from .packed import (
    BUCKET,
    PackedLinear,
    bucket_group,
    dequantize_linear,
    pack_linear,
    plane_unpack,
)
from .topk_fused import (
    KMAX,
    dequant_matmul_topk,
    dequant_matmul_topk_plan,
    dequant_matmul_topk_reference,
    pick_generator_group,
)

__all__ = [
    "BUCKET",
    "KMAX",
    "PackedLinear",
    "beam_combine_topk",
    "beam_combine_topk_reference",
    "bucket_group",
    "dequant_matmul",
    "dequant_matmul_plan",
    "dequant_matmul_reference",
    "dequant_matmul_topk",
    "dequant_matmul_topk_plan",
    "dequant_matmul_topk_reference",
    "dequantize_linear",
    "fake_quant_buckets",
    "fake_quant_buckets_reference",
    "pack_linear",
    "pick_generator_group",
    "plane_unpack",
]
