"""The one generator of every traffic mix. A mix is a JSON file of
parameters (``portbench/traffic/<mix>.json``); the path it names reads the
batches made here.

Sizes do not depend on the seed. Sentence lengths are lognormal, of the
mix's ``mean`` and ``sigma``, rounded and clipped to [``min``, ``max``]. A
mix's batches form a cycle in which each length bucket has a fixed count,
its share of the corpus's batches under that distribution (a bucket's
share of sentences over the sentences a batch of it holds; largest
remainder), ordered by stride scheduling so that every stretch of the
cycle holds the buckets in about their shares; a seed rotates the cycle,
shuffles which sentence gets which length and draws every token. The
lengths of each batch come from one fixed stream, drawn within the
bucket's range ((previous bucket, bucket]). So every seed sends the same
set of sizes, in another order and with other tokens.

Keys a mix may hold:
- ``buckets``, ``batches``, ``lengths`` (``mean``, ``sigma``, ``min``,
  ``max``), ``first_token`` (tokens are uniform in [first_token, vocab)):
  the bucketed mixes;
- ``batch_size`` (sentences a batch) or ``tokens_per_batch`` (padded
  target tokens a batch: ``tokens_per_batch / bucket`` sentences);
- ``stream`` = ``"zipf"`` with ``zipf_exponent``, ``batch_size``, ``bptt``
  and ``windows``: contiguous BPTT windows over one token stream.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

PAD, BOS, EOS = 0, 1, 2
SIZES_STREAM = 0  # the fixed stream of lengths
Batch = Dict[str, np.ndarray]


def _rng(seed: int, *stream) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def median(spec: dict) -> float:
    """The lognormal's median from its ``mean`` and ``sigma``."""
    return spec["mean"] * math.exp(-spec["sigma"] ** 2 / 2)


def bucket_shares(traffic: dict) -> List[float]:
    """Each bucket's share of the sentences: the mass of the rounded,
    clipped lengths in its range."""
    spec, buckets = traffic["lengths"], traffic["buckets"]

    def below(x: float) -> float:  # P(length < x) before rounding
        z = math.log(x / median(spec)) / spec["sigma"]
        return 0.5 * (1 + math.erf(z / math.sqrt(2)))

    edges = [0.0] + [below(b + 0.5) for b in buckets[:-1]] + [1.0]
    return [hi - lo for lo, hi in zip(edges, edges[1:])]


def bucket_counts(traffic: dict) -> List[int]:
    """The cycle's batches of each bucket: its share of the sentences over
    the sentences a batch of it holds, of ``batches``, largest remainder."""
    per = [s / _rows(traffic, b) for b, s in enumerate(bucket_shares(traffic))]
    n = traffic["batches"]
    raw = [p * n / sum(per) for p in per]
    counts = [int(r) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])[: n - sum(counts)]:
        counts[i] += 1
    return counts


def schedule(traffic: dict, seed: int) -> List[int]:
    """The bucket index of each batch of the cycle."""
    counts = bucket_counts(traffic)
    n = sum(counts)
    done = [0] * len(counts)
    order = []
    for pos in range(n):
        lag = [counts[b] * (pos + 1) / n - done[b] for b in range(len(counts))]
        b = max(range(len(counts)), key=lambda b: (lag[b], -b))
        done[b] += 1
        order.append(b)
    shift = int(_rng(seed, 1).integers(n))
    return order[shift:] + order[:shift]


def _lengths(rng: np.random.Generator, n: int, lo: int, hi: int, spec: dict) -> np.ndarray:
    out = np.empty(0, dtype=np.int64)
    while out.size < n:
        x = np.rint(median(spec) * np.exp(spec["sigma"] * rng.standard_normal(4 * n + 64)))
        x = np.clip(x, spec["min"], spec["max"]).astype(np.int64)
        out = np.concatenate([out, x[(x >= lo) & (x <= hi)]])
    return out[:n]


def _bucket_range(traffic: dict, b: int):
    lo = traffic["buckets"][b - 1] + 1 if b else traffic["lengths"]["min"]
    return lo, traffic["buckets"][b]


def _rows(traffic: dict, b: int) -> int:
    if "tokens_per_batch" in traffic:
        return traffic["tokens_per_batch"] // traffic["buckets"][b]
    return traffic["batch_size"]


def _cycle_lengths(traffic: dict, order: List[int], sides: int) -> List[np.ndarray]:
    """The lengths of each batch of the cycle ([sides, rows]), from the
    fixed stream: the k-th batch of bucket b always gets the same ones."""
    seen = [0] * len(traffic["buckets"])
    out = []
    for b in order:
        lo, hi = _bucket_range(traffic, b)
        rng = _rng(SIZES_STREAM, b, seen[b])
        seen[b] += 1
        out.append(_lengths(rng, sides * _rows(traffic, b), lo, hi,
                            traffic["lengths"]).reshape(sides, -1))
    return out


def _tokens(rng, shape, lengths, traffic: dict, vocab: int) -> np.ndarray:
    toks = rng.integers(traffic["first_token"], vocab, shape)
    return np.where(np.arange(shape[1])[None, :] < lengths[:, None], toks, PAD)


def sources(traffic: dict, vocab: int, seed: int) -> List[Batch]:
    """The serving cycle: per batch ``src`` [B, bucket] and ``src_len`` [B]
    (tokens past a sentence's length are PAD)."""
    order = schedule(traffic, seed)
    out = []
    for i, (b, lens) in enumerate(zip(order, _cycle_lengths(traffic, order, 1))):
        rng = _rng(seed, 2, i)
        src_len = rng.permutation(lens[0])
        bucket = traffic["buckets"][b]
        out.append({"src": _tokens(rng, (src_len.size, bucket), src_len, traffic, vocab),
                    "src_len": src_len})
    return out


def pairs(traffic: dict, vocab: int, seed: int) -> List[Batch]:
    """The seq2seq training cycle: per batch the trainer's ``src``,
    ``src_len``, ``tgt_in`` (BOS, then the target shifted), ``tgt_out``
    (the target, its last real token EOS) and ``tgt_mask`` (1 on the real
    target tokens), all padded to the batch's bucket."""
    order = schedule(traffic, seed)
    out = []
    for i, (b, lens) in enumerate(zip(order, _cycle_lengths(traffic, order, 2))):
        rng = _rng(seed, 3, i)
        src_len, tgt_len = rng.permutation(lens[0]), rng.permutation(lens[1])
        bucket = traffic["buckets"][b]
        rows = src_len.size
        src = _tokens(rng, (rows, bucket), src_len, traffic, vocab)
        tgt_out = _tokens(rng, (rows, bucket), tgt_len, traffic, vocab)
        tgt_out[np.arange(rows), tgt_len - 1] = EOS
        tgt_in = np.concatenate([np.full((rows, 1), BOS), tgt_out[:, :-1]], axis=1)
        mask = (np.arange(bucket)[None, :] < tgt_len[:, None]).astype(np.float32)
        out.append({"src": src, "src_len": src_len, "tgt_in": tgt_in * (mask > 0),
                    "tgt_out": tgt_out, "tgt_mask": mask})
    return out


def stream_windows(traffic: dict, vocab: int, seed: int) -> List[Batch]:
    """The LM cycle: ``windows`` contiguous BPTT windows (``input``,
    ``target`` [batch_size, bptt]) over one Zipf-distributed token stream
    per row (token ``k`` with probability ∝ (k + 1)^-exponent)."""
    b, t, n = traffic["batch_size"], traffic["bptt"], traffic["windows"]
    p = (np.arange(vocab) + 1.0) ** -traffic["zipf_exponent"]
    cdf = np.cumsum(p / p.sum())
    rng = _rng(seed, 4)
    stream = np.minimum(np.searchsorted(cdf, rng.random((b, n * t + 1))), vocab - 1)
    return [{"input": stream[:, j * t:(j + 1) * t], "target": stream[:, j * t + 1:(j + 1) * t + 1]}
            for j in range(n)]


def real_target_tokens(batch: Batch) -> int:
    """The batch's non-pad target tokens."""
    if "tgt_mask" in batch:
        return int(batch["tgt_mask"].sum())
    return int(batch["target"].size)
