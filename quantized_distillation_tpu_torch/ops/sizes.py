"""Compressed-model-size accounting (the port's own copy of the JAX
package's ``ops/sizes.py``).

Bits per weight at a given bit-width, per-bucket scaling overhead (2 floats
a bucket for linear min-max scaling, 1 for abs-max), layers kept at full
precision, and an optional Huffman factor measured from the real index
stream (:func:`.huffman.mean_bits_per_symbol`). The measured size of a
written ``.qdt`` file (:mod:`..utils.artifact`) is what this estimates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional

import numpy as np

from .bucketing import DEFAULT_BUCKET_SIZE, LINEAR, floats_per_bucket, num_buckets
from .huffman import mean_bits_per_symbol

FP32_BITS = 32
SCALE_BITS = 32  # scaling constants stored as fp32, as in the reference


@dataclass
class SizeReport:
    quantized_bits: float  # payload bits for quantized params (post-Huffman if used)
    scale_overhead_bits: float
    fp_bits: float  # bits of params left in full precision
    n_params: int
    fp32_total_bits: float = 0.0
    mean_bits_per_weight: Dict[str, float] = field(default_factory=dict)

    @property
    def total_bits(self) -> float:
        return self.quantized_bits + self.scale_overhead_bits + self.fp_bits

    @property
    def total_mb(self) -> float:
        return self.total_bits / 8 / 1024 / 1024

    @property
    def compression_ratio(self) -> float:
        return self.fp32_total_bits / max(self.total_bits, 1.0)


def model_size_report(
    param_sizes: Mapping[str, int],
    bits: int | Mapping[str, int],
    *,
    bucket_size: int = DEFAULT_BUCKET_SIZE,
    scaling: str = LINEAR,
    exclude: Iterable[str] = (),
    index_streams: Optional[Mapping[str, np.ndarray]] = None,
) -> SizeReport:
    """Size report for a model quantized at ``bits`` per weight.

    Args:
      param_sizes: parameter name → element count.
      bits: uniform bit-width, or per-parameter mapping (for the automatic
        bit-assignment heuristic, :mod:`..train.bits`).
      exclude: parameter names kept at fp32 (reference's skip-first/last-layer
        option).
      index_streams: optional name → quantization-index array; when given, the
        payload uses the measured Huffman mean bits/weight instead of ``bits``.
    """
    exclude = set(exclude)
    q_bits = 0.0
    overhead = 0.0
    fp_bits = 0.0
    n_params = 0
    fp32_total = 0.0
    mean_bits: Dict[str, float] = {}
    fpb = floats_per_bucket(scaling)
    for name, n in param_sizes.items():
        n_params += n
        fp32_total += n * FP32_BITS
        if name in exclude:
            fp_bits += n * FP32_BITS
            continue
        b = bits[name] if isinstance(bits, Mapping) else bits
        if index_streams is not None and name in index_streams:
            mb = mean_bits_per_symbol(index_streams[name])
        else:
            mb = float(b)
        mean_bits[name] = mb
        q_bits += n * mb
        overhead += num_buckets(n, bucket_size) * fpb * SCALE_BITS
    return SizeReport(
        quantized_bits=q_bits,
        scale_overhead_bits=overhead,
        fp_bits=fp_bits,
        n_params=n_params,
        fp32_total_bits=fp32_total,
        mean_bits_per_weight=mean_bits,
    )
