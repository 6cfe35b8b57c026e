"""Quantization math of the PyTorch port: bucketed scaling, the uniform
grid and learned codebooks (quantize, dequantize, fake-quant with a
straight-through gradient)."""

from . import bucketing, codebook, uniform
from .bucketing import (
    ABSMAX,
    DEFAULT_BUCKET_SIZE,
    LINEAR,
    ScaleParams,
    apply_scale,
    compute_scale,
    from_buckets,
    invert_scale,
    num_buckets,
    to_buckets,
)
from .codebook import CodebookQuantizedTensor, init_points, nearest_point_idx
from .uniform import QuantizedTensor, fake_quant, quantize_levels_01, ste_fake_quant

__all__ = [
    "bucketing",
    "codebook",
    "uniform",
    "ABSMAX",
    "DEFAULT_BUCKET_SIZE",
    "LINEAR",
    "ScaleParams",
    "apply_scale",
    "compute_scale",
    "from_buckets",
    "invert_scale",
    "num_buckets",
    "to_buckets",
    "CodebookQuantizedTensor",
    "init_points",
    "nearest_point_idx",
    "QuantizedTensor",
    "fake_quant",
    "quantize_levels_01",
    "ste_fake_quant",
]
