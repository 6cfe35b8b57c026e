"""Huffman-coding size accounting for quantization indices (the port's own
copy of the JAX package's ``ops/huffman.py``, which imports no JAX but is
not shared).

Build a Huffman code over the empirical frequencies of the quantization
levels or codebook indices and report the mean code length, which
multiplies into the compressed-size estimate (:mod:`.sizes`). Host-side
NumPy and pure Python: accounting only. The codec that writes coded bytes
is :mod:`..native`."""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Sequence

import numpy as np


def code_lengths(freqs: Dict[int, int]) -> Dict[int, int]:
    """Huffman code length per symbol from a frequency table.

    Standard two-queue/heap construction; a single-symbol alphabet gets code
    length 1 (one bit still needed to say "it's that symbol" in a stream).
    """
    syms = [s for s, f in freqs.items() if f > 0]
    if not syms:
        return {}
    if len(syms) == 1:
        return {syms[0]: 1}
    # Heap of (freq, tiebreak, {symbol: depth}).
    heap = [(freqs[s], i, {s: 0}) for i, s in enumerate(syms)]
    heapq.heapify(heap)
    counter = len(syms)
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        merged = {s: d + 1 for s, d in a.items()}
        merged.update({s: d + 1 for s, d in b.items()})
        heapq.heappush(heap, (fa + fb, counter, merged))
        counter += 1
    return heap[0][2]


def mean_bits_per_symbol(indices: Sequence[int] | np.ndarray) -> float:
    """Mean Huffman code length (bits/symbol) of an index stream."""
    arr = np.asarray(indices).reshape(-1)
    if arr.size == 0:
        return 0.0
    freqs = Counter(arr.tolist())
    lengths = code_lengths(dict(freqs))
    total = sum(freqs[s] * lengths[s] for s in freqs)
    return total / arr.size


def entropy_bits_per_symbol(indices: Sequence[int] | np.ndarray) -> float:
    """Shannon entropy of the index stream (lower bound on Huffman length)."""
    arr = np.asarray(indices).reshape(-1)
    if arr.size == 0:
        return 0.0
    _, counts = np.unique(arr, return_counts=True)
    p = counts / arr.size
    return float(-(p * np.log2(p)).sum())
