"""Quantization math of the PyTorch port: bucketed scaling and the uniform
grid (quantize, dequantize, fake-quant with a straight-through gradient)."""

from . import bucketing, uniform
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
from .uniform import QuantizedTensor, fake_quant, quantize_levels_01, ste_fake_quant

__all__ = [
    "bucketing",
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
    "QuantizedTensor",
    "fake_quant",
    "quantize_levels_01",
    "ste_fake_quant",
]
