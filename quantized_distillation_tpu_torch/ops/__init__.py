"""Quantization math of the PyTorch port: bucketed scaling, the uniform
grid and learned codebooks (quantize, dequantize, fake-quant with a
straight-through gradient), sub-byte packing of levels, and compressed-size
accounting (Huffman code lengths, :func:`.sizes.model_size_report`)."""

from . import bucketing, codebook, huffman, packing, sizes, uniform
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
from .huffman import code_lengths, entropy_bits_per_symbol, mean_bits_per_symbol
from .packing import pack, unpack, values_per_byte
from .sizes import SizeReport, model_size_report
from .uniform import QuantizedTensor, fake_quant, quantize_levels_01, ste_fake_quant

__all__ = [
    "bucketing",
    "codebook",
    "huffman",
    "packing",
    "sizes",
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
    "code_lengths",
    "entropy_bits_per_symbol",
    "mean_bits_per_symbol",
    "pack",
    "unpack",
    "values_per_byte",
    "SizeReport",
    "model_size_report",
    "QuantizedTensor",
    "fake_quant",
    "quantize_levels_01",
    "ste_fake_quant",
]
