"""Packed weight format, the hand-written serving kernels, the fake-quant
kernel of the train step, the grouped expert matmul and the LSTM cell.

Each kernel wrapper dispatches on its input's device: a CPU tensor runs the
plain PyTorch version beside it, a CUDA tensor launches the CUDA kernel
built from ``csrc/`` (see :mod:`._build`) or raises. Each counts its
launches in an attribute; :data:`LAUNCH_COUNTERS` names them all.
"""

from typing import Dict

import torch

from .beam_combine import (
    beam_advance,
    beam_advance_reference,
    beam_combine_topk,
    beam_combine_topk_reference,
)
from .dequant_matmul import dequant_matmul, dequant_matmul_plan, dequant_matmul_reference
from .fake_quant import fake_quant_buckets, fake_quant_buckets_reference
from .grouped_matmul import grouped_matmul, grouped_matmul_reference
from .lstm_cell import lstm_cell, lstm_cell_reference
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

# launch counter name → (wrapper, attribute it counts in)
LAUNCH_COUNTERS = {
    "dequant_matmul": (dequant_matmul, "launches"),
    "dequant_matmul_lut": (dequant_matmul, "launches_lut"),
    "dequant_matmul_topk": (dequant_matmul_topk, "launches"),
    "dequant_matmul_topk_lut": (dequant_matmul_topk, "launches_lut"),
    "beam_combine_topk": (beam_combine_topk, "launches"),
    "beam_advance": (beam_advance, "launches"),
    "fake_quant_buckets": (fake_quant_buckets, "launches"),
    "grouped_matmul": (grouped_matmul, "launches"),
    "grouped_matmul_wgrad": (grouped_matmul, "launches_wgrad"),
    "lstm_cell": (lstm_cell, "launches"),
    "lstm_cell_backward": (lstm_cell, "launches_backward"),
}


def launch_counts() -> Dict[str, int]:
    """Every launch counter's value now."""
    return {name: getattr(fn, attr) for name, (fn, attr) in LAUNCH_COUNTERS.items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches counted since ``before`` (a :func:`launch_counts`),
    by counter, leaving out the counters that did not move."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {n: c - before[n] for n, c in launch_counts().items() if c != before[n]}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set the named launch counters (a replayed CUDA graph adds the
    launches it captured this way)."""
    for name, n in counts.items():
        fn, attr = LAUNCH_COUNTERS[name]
        setattr(fn, attr, n)


__all__ = [
    "BUCKET",
    "KMAX",
    "LAUNCH_COUNTERS",
    "PackedLinear",
    "beam_advance",
    "beam_advance_reference",
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
    "grouped_matmul",
    "grouped_matmul_reference",
    "launch_counts",
    "launches_since",
    "lstm_cell",
    "lstm_cell_reference",
    "pack_linear",
    "pick_generator_group",
    "plane_unpack",
    "set_launch_counts",
]
