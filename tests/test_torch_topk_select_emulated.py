"""The tensor-core generator's selection stage, run on the CPU.

``select_tile`` and ``write_split`` of ``csrc/topk_fused.cu`` (filter by
the row's k-th value, the tile's own best pairs where a quad has many
survivors, the quad's merge through a shared-memory scratch) are cut out of
the source and compiled with ``g++`` against ``tests/warp_emulation.h``,
which runs one warp as 32 host threads. Each split's entry must hold the
split's exact top-k first, in (value desc, index asc) order, then only real
pairs of the split, and its (max, sum) the split's logsumexp: on random
logits and on streams built to defeat a filter (every column a record,
ties across lanes, quads, tiles and splits, one lane holding every large
value, the best in the last column, masked columns past N).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from quantized_distillation_tpu_torch.kernels import _build

KMAX = 8
EMPTY = np.iinfo(np.int32).max
HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("topk_select")
    src = (_build.CSRC / "topk_fused.cu").read_text()
    cut = (src[src.index("constexpr int KMAX = 8;"):
               src.index("// ------------------------------------------------- f32 compute, CUDA cores")]
           + src[src.index("// ----------------------------------------------- bf16 compute, tensor cores"):
                 src.index("// Rounds rows row0 .. row0 + ROWS - 1 of x to bf16")])
    (out / "topk_select.inc").write_text(cut)
    exe = out / "topk_select_emulated"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", f"-I{HERE}", f"-I{out}",
                    str(HERE / "topk_select_emulated.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, text=True)
    return exe, out


def _run(emulated, logits, nsub, n_valid, ktop, tps):
    exe, out = emulated
    ncols = logits.shape[1]
    logits.astype(np.float32).tofile(out / "in.f32")
    subprocess.run([str(exe), str(out / "in.f32"), str(nsub), str(ncols), str(n_valid), str(ktop),
                    str(tps), str(out / "out.bin")], check=True, timeout=120)
    splits = -(-(ncols // (64 * nsub)) // tps)
    raw = np.fromfile(out / "out.bin", dtype=np.uint8)
    nv = 16 * splits * KMAX * 4
    v = raw[:nv].view(np.float32).reshape(16, splits, KMAX)
    i = raw[nv:2 * nv].view(np.int32).reshape(16, splits, KMAX)
    ms = raw[2 * nv:].view(np.float32).reshape(2, 16, splits)
    return v, i, ms[0], ms[1]


def _check(logits, got, nsub, n_valid, ktop, tps):
    v, i, m, s = got
    width = tps * 64 * nsub
    for r in range(16):
        for sp in range(v.shape[1]):
            lo, hi = sp * width, min(n_valid, (sp + 1) * width)
            if lo >= hi:
                continue
            cols = np.arange(lo, hi)
            vals = logits[r, lo:hi]
            order = np.lexsort((cols, -vals))[:ktop]
            k = len(order)
            where = f"row {r} split {sp}"
            np.testing.assert_array_equal(i[r, sp, :k], cols[order], err_msg=where)
            np.testing.assert_array_equal(v[r, sp, :k], vals[order], err_msg=where)
            real = i[r, sp] != EMPTY
            idx = i[r, sp][real]
            assert len(set(idx.tolist())) == len(idx), where
            assert ((idx >= lo) & (idx < hi)).all(), where
            np.testing.assert_array_equal(v[r, sp][real], logits[r, idx], err_msg=where)
            x = vals.astype(np.float64)
            want = x.max() + np.log(np.exp(x - x.max()).sum())
            assert abs(m[r, sp] + np.log(s[r, sp]) - want) <= 1e-4 * max(1.0, abs(want)), where


def _streams(rng, ncols, n_valid):
    n = np.arange(ncols, dtype=np.float32)
    rows = np.arange(16, dtype=np.float32)[:, None]
    lane0 = (np.arange(ncols) % 8) // 2 == 0  # the columns of lane 0 of each quad
    last = rng.standard_normal((16, ncols)).astype(np.float32)
    last[:, n_valid - 1] = 100.0
    return {
        "random": rng.standard_normal((16, ncols)).astype(np.float32),
        "ascending": n[None, :] * 0.5 + rows,  # every column a record
        "descending": -n[None, :] + rows,
        "equal": np.zeros((16, ncols), np.float32),
        "few_values": rng.integers(0, 3, (16, ncols)).astype(np.float32),
        "ascending_ties": np.repeat(np.floor(n / 3)[None, :], 16, axis=0),
        "one_lane": (rng.standard_normal((16, ncols)) + 50.0 * lane0 + 1e-3 * n).astype(np.float32),
        "best_last": last,
    }


# (tiles, N short of the last tile, tiles per split): several splits; a
# ragged N; N = 3 < k, so the lists keep empty entries; one split
SHAPES = [(12, 0, 4), (12, 37, 5), (1, None, 1), (3, 0, 3)]


@pytest.mark.parametrize("nsub", [1, 2])
@pytest.mark.parametrize("ktop", [1, 5, 8])
def test_select_tile_exact_on_adversarial_streams(emulated, nsub, ktop):
    rng = np.random.default_rng(100 * nsub + ktop)
    for tiles, short, tps in SHAPES:
        ncols = tiles * 64 * nsub
        n_valid = 3 if short is None else ncols - short
        for name, logits in _streams(rng, ncols, n_valid).items():
            try:
                _check(logits, _run(emulated, logits, nsub, n_valid, ktop, tps), nsub, n_valid,
                       ktop, tps)
            except AssertionError as e:
                raise AssertionError(f"{name}, {tiles} tiles, N = {n_valid}, {tps} a split") from e
