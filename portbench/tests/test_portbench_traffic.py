"""The traffic generator: one seed repeats, seeds differ, and every seed
sends the same sizes (bucket counts, lengths, real tokens) in another
order."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

MIXES = Path(__file__).resolve().parent.parent / "traffic"
SEEDS = (0, 7, 2**31 + 11)


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def same(a, b):
    return all(k in b and np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("seed", SEEDS)
def test_sources_repeat_and_differ(seed):
    tr = mix("wmt-offline-beam5")
    a, b = traffic.sources(tr, 32000, seed), traffic.sources(tr, 32000, seed)
    assert all(same(x, y) for x, y in zip(a, b, strict=True))
    c = traffic.sources(tr, 32000, seed + 1)
    assert not all(same(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("name,counts", [("wmt-offline-beam5", [19, 32, 13]),
                                         ("wmt-kd-4096tok", [9, 30, 25]),
                                         ("wmt-kd-4096tok-x4", [9, 30, 25])])
def test_bucket_counts_from_the_lengths(name, counts):
    """A bucket's batches are its share of the sentences over the sentences
    a batch of it holds; the shares are the lognormal's mass in its range."""
    tr = mix(name)
    shares = traffic.bucket_shares(tr)
    assert sum(shares) == pytest.approx(1.0)
    draws = np.rint(traffic.median(tr["lengths"])
                    * np.exp(0.5 * np.random.default_rng(0).standard_normal(400_000)))
    draws = np.clip(draws, 4, 64)
    seen = [np.mean((draws > lo) & (draws <= hi)) for lo, hi in ((0, 16), (16, 32), (32, 64))]
    assert shares == pytest.approx(seen, abs=3e-3)
    assert traffic.bucket_counts(tr) == counts


def test_sizes_fixed():
    tr = mix("wmt-offline-beam5")
    counts = traffic.bucket_counts(tr)
    sizes = []
    for seed in SEEDS:
        cycle = traffic.sources(tr, 32000, seed)
        widths = [b["src"].shape[1] for b in cycle]
        assert [widths.count(L) for L in tr["buckets"]] == counts
        assert all(b["src"].shape[0] == 256 for b in cycle)
        for b in cycle:
            L = b["src"].shape[1]
            lo = {16: 4, 32: 17, 64: 33}[L]
            assert b["src_len"].min() >= lo and b["src_len"].max() <= L
            real = np.arange(L)[None, :] < b["src_len"][:, None]
            assert (b["src"][real] >= 4).all() and (b["src"][~real] == 0).all()
        sizes.append(sorted(int(x) for b in cycle for x in b["src_len"]))
    assert sizes[0] == sizes[1] == sizes[2]


def test_every_stretch_holds_the_shares():
    tr = mix("wmt-offline-beam5")
    counts = traffic.bucket_counts(tr)
    order = traffic.schedule(tr, 5) * 2
    for start in range(64):
        part = order[start:start + 16]
        assert all(abs(part.count(b) - 16 * counts[b] / 64) < 1.5 for b in range(3))


def test_lognormal_lengths():
    tr = mix("wmt-offline-beam5")
    lens = np.concatenate([b["src_len"] for b in traffic.sources(tr, 32000, 3)])
    assert lens.min() >= 4 and lens.max() <= 64
    assert 18 <= np.median(lens) <= 26
    assert np.mean(lens) == pytest.approx(24.44, rel=0.05)


def test_pairs_tokens_and_masks():
    tr = mix("wmt-kd-4096tok")
    totals = set()
    for seed in SEEDS:
        cycle = traffic.pairs(tr, 32000, seed)
        assert all(b["tgt_out"].size == 4096 for b in cycle)
        for b in cycle:
            rows = np.arange(b["tgt_out"].shape[0])
            n = b["tgt_mask"].sum(1).astype(int)
            assert (b["tgt_out"][rows, n - 1] == traffic.EOS).all()
            assert (b["tgt_in"][:, 0] == traffic.BOS).all()
            assert np.array_equal(b["tgt_in"][:, 1:] * b["tgt_mask"][:, 1:],
                                  b["tgt_out"][:, :-1] * b["tgt_mask"][:, 1:])
        totals.add(sum(traffic.real_target_tokens(b) for b in cycle))
    assert len(totals) == 1 and 0.65 * 64 * 4096 < totals.pop() < 0.8 * 64 * 4096


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_windows_contiguous(seed):
    tr = mix("ptb-bptt35")
    w = traffic.stream_windows(tr, 10000, seed)
    assert len(w) == 64 and w[0]["input"].shape == (256, 35)
    assert np.array_equal(w[0]["target"][:, :-1], w[0]["input"][:, 1:])
    assert np.array_equal(w[1]["input"][:, 0], w[0]["target"][:, -1])
    assert w[0]["input"].max() < 10000
    again = traffic.stream_windows(tr, 10000, seed)
    assert all(same(a, b) for a, b in zip(w, again))
    other = traffic.stream_windows(tr, 10000, seed + 1)
    assert not same(w[0], other[0])
    # Zipf: the commonest token is the first
    assert np.bincount(w[0]["input"].ravel()).argmax() == 0
