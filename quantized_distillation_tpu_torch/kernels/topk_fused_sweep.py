"""Tile and ablation sweep of the tensor-core fused generator on the card.

    python -m quantized_distillation_tpu_torch.kernels.topk_fused_sweep tiles
    python -m quantized_distillation_tpu_torch.kernels.topk_fused_sweep ablate [--bits 2,4,8]
    python -m quantized_distillation_tpu_torch.kernels.topk_fused_sweep count

Builds variants of ``csrc/topk_fused.cu`` that differ from the sources in
``csrc/`` by the edits of one preset below, each of which replaces one
statement of code (``_build.build_variants``: one ``nvcc`` per variant, all
started together). Nothing in the package imports this module. Then it
times every variant's whole call (pass 1 and the merge) with
:func:`graph_ms` at the serving shape (student_medium: 1280 rows, K = 256,
x f32 as the decode step gives it, k = 5), on the uniform generator (N =
32768 with a -1e9 bias past 32000), on the same weights under a climbing
bias (every column a record: the selection's worst case) and on a codebook
generator (N = 32000 packed to 32768 with edge weights, masked in the
kernel), beside one PyTorch call computing the same function (bf16
``torch.matmul`` on the dequantized weight, + bias, ``torch.topk``,
``torch.logsumexp``). It prints
the card's name and power limit, then one JSON line per generator: for each
variant its plan (rows per block, columns per tile, splits, blocks,
blocks per SM), microseconds per call and whether values and lse match the
plain version within the tests' 1e-4 with equal indices. ``tiles`` compares
configuration tables (``GEN_SHAPES``), ring depth and splits; ``ablate``
takes one stage of pass 1 out at a time, which shows where the chosen
kernel's time goes (those variants compute something else, so they do not
match); ``count`` builds the selection's counters in (they cost time, so
its timing is not the kernel's) and adds, per generator, the share of the
logits that passed the filter and the tiles merged and taken by the heavy
path per row and split. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ..utils.profiling import graph_ms
from . import _build
from .packed import dequantize_linear, pack_linear
from .topk_fused import (
    _ARGTYPES,
    _PLAN_ARGTYPES,
    _PLAN_KEYS,
    KMAX,
    dequant_matmul_topk_reference,
)

_SHAPES = "constexpr GenShape GEN_SHAPES[] = {{2, 1, 128}, {1, 1, 64}};"
_WAVE = "split_vocab((a.N + bn - 1) / bn, row_tiles, tc::sm_count() * max(per_sm, 1) / row_tiles, plan);"


def _gen(old: str, new: str):
    return ("topk_fused.cu", old, new)


def _table(shapes: str):
    """Edit: the configuration table (warpgroups, 64-row tiles each, columns)."""
    return _gen(_SHAPES, "constexpr GenShape GEN_SHAPES[] = {" + shapes + "};")


def _waves(expr: str):
    """Edit: how many splits the plan asks for, as an expression of the
    blocks one wave holds."""
    return _gen(_WAVE, _WAVE.replace("tc::sm_count() * max(per_sm, 1)", expr))


_NO_SELECT = _gen("select_tile<MT, W::NSUB>(acc, b, col0, ktop, reinterpret_cast<float*>(b_tiles), rows);", ";")
_NO_LSE = _gen("for (int e = 0; e < VALS; ++e) sum4[e % 4] += exp_ftz(v[e] - ref);", ";")
# the whole top-k stage: nothing passes the filter, so no heavy path and no merge
_NO_FILTER = _gen("for (int e = 0; e < VALS; ++e) cands[r] |= (uint32_t)(v[e] > rows.kth[r]) << e;", ";")
# the tile's own key off: a split's first tile merges every value
_NO_HEAVY = _gen("if (__any_sync(FULL, quad_sum(__popc(cand)) > HEAVY)) {", "if (false) {")
# no inserts: the threshold stays at the first tile's key, never refreshed,
# so the filter and the scratch stores run at least as often as chosen's
_NO_MERGE = [_gen("rows.kth[r] = kv;", ";"),
             _gen("if (better(lv, li, kv, ki)) kv = lv, ki = li;",
                  "if (better(lv, li, kv, ki)) kv = lv, ki = li;\n        rows.kth[r] = kv;"),
             _gen("while (w0 | w1) {", "while (false && (w0 | w1)) {")]
_NO_DEQUANT = _gen("tc::transform_b<W>(task, p_stage(st), so_stage(st), lut, table, bt);", ";")
_NO_MMA = _gen("for (int k16 = 0; k16 < tc::BK / 16; ++k16) {", "for (int k16 = 0; k16 < 0; ++k16) {")
_NO_X = _gen("load_x_resident<XT, G::ROWS, W::THREADS>(x, M, K, row0, ks, vec, a_tiles);", ";")
# Counters, read by qdt_topk_fused_counts: values that passed the filter,
# (row, tile)s merged, (row, tile)s that took the heavy path
_COUNT = [
    _gen("constexpr int HEAVY = 2 * KMAX;",
         "constexpr int HEAVY = 2 * KMAX;\n__device__ unsigned long long sel_counts[3];\n"
         "__device__ __forceinline__ void sel_count(int k, unsigned n) {\n"
         "  n = __reduce_add_sync(FULL, n);\n"
         "  if (threadIdx.x % 32 == 0 && n) atomicAdd(&sel_counts[k], (unsigned long long)n);\n}"),
    _gen("ki += ki != INT_MAX;", "sel_count(2, threadIdx.x % 4 == 0);\n        ki += ki != INT_MAX;"),
    _gen("float* const warp = scratch + threadIdx.x / 32 * 32 * VALS;",
         "sel_count(0, __popc(cand));\n"
         "      sel_count(1, (quad_sum(__popc(cand)) > 0) & (threadIdx.x % 4 == 0));\n"
         "      float* const warp = scratch + threadIdx.x / 32 * 32 * VALS;"),
    _gen('extern "C" int qdt_topk_fused_plan(',
         'extern "C" int qdt_topk_fused_counts(unsigned long long* host, int reset) {\n'
         "  cudaError_t e = cudaMemcpyFromSymbol(host, qdt::sel_counts, sizeof(qdt::sel_counts));\n"
         "  const unsigned long long zero[3] = {};\n"
         "  if (e == cudaSuccess && reset) e = cudaMemcpyToSymbol(qdt::sel_counts, zero, sizeof(zero));\n"
         "  return static_cast<int>(e);\n}\n"
         'extern "C" int qdt_topk_fused_plan('),
]
_NO_COPY = [_gen("tc::mbar_expect_tx(tma && tid == 0, &full[st], W::P_BYTES + W::SO_BYTES);", ";"),
            ("dequant_tile_tc.cuh", "const bool lead = tid == 0;", "const bool lead = tid < 0;"),
            _gen("if (tma) tc::mbar_wait(&full[st], (i / G::STAGES) & 1);  // or the TMA's", ";")]

PRESETS = {
    "tiles": {
        "chosen": [],
        "rows128_bn64": [_table("{2, 1, 64}, {1, 1, 64}")],
        "rows256_bn64": [_table("{2, 2, 64}, {1, 1, 64}")],
        "rows128_wg1": [_table("{1, 2, 64}, {1, 1, 64}")],
        "rows64": [_table("{1, 1, 64}")],
        "rows64_bn128": [_table("{1, 1, 128}")],
        "ahead_3": [("dequant_tile_tc.cuh", "constexpr int AHEAD = 2;", "constexpr int AHEAD = 3;")],
        "splits_2_waves": [_waves("2 * tc::sm_count() * max(per_sm, 1)")],
        "splits_half_wave": [_waves("tc::sm_count() * max(per_sm, 1) / 2")],
    },
    "ablate": {
        "chosen": [],
        "no_select": [_NO_SELECT],
        "no_lse": [_NO_LSE],
        "no_filter": [_NO_FILTER],
        "no_heavy": [_NO_HEAVY],
        "no_merge": _NO_MERGE,
        "no_dequant": [_NO_DEQUANT],
        "no_wgmma": [_NO_MMA],
        "no_x_load": [_NO_X],
        "no_copy": _NO_COPY,
        "loop_only": _NO_COPY + [_NO_DEQUANT, _NO_MMA, _NO_SELECT, _NO_X],
    },
    "count": {"count": _COUNT},
}

ROWS, K, V, K_TOP = 1280, 256, 32000, 5  # B = 256 x beam 5; student_medium; WMT vocab
PADDED = 32768  # the vocab padded to the generator group (pick_generator_group(1280) = 16)


def generators(bits: int, gen: torch.Generator):
    """The uniform serving generator (N padded, -1e9 bias past V), the same
    weights under a bias that climbs 16 a column (every column below V a
    new record: the selection's worst case) and a codebook generator (N =
    V, padded with edge weights, masked in the kernel)."""
    bias = torch.randn(PADDED, generator=gen)
    bias[V:] = -1e9
    w = torch.randn(K, PADDED, generator=gen) * 0.1
    uni = pack_linear(w, bits, bias=bias)
    climb = bias.clone()
    climb[:V] = 16.0 * torch.arange(V, dtype=torch.float32)
    ascending = pack_linear(w, bits, bias=climb)
    pts = torch.rand(1 << bits, generator=gen) * 1.2 - 0.1
    lut = pack_linear(torch.randn(K, V, generator=gen) * 0.1, bits, bias=bias[:V].clone(),
                      points=pts, max_group=16)
    return {"uniform": uni.to("cuda"), "uniform_ascending": ascending.to("cuda"),
            "lut": lut.to("cuda")}


def selection_counts(lib, call, variant: str, n: int, splits: int) -> dict:
    """The counting variant's engagement counters over one call: the share
    of the logits that passed the filter, and per row and split the tiles
    merged and the tiles that took the heavy path."""
    counts = (ctypes.c_ulonglong * 3)()
    read = _build.bind(lib, "qdt_topk_fused_counts", [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int])
    _build.check(read(counts, 1), variant)  # and reset
    call()
    torch.cuda.synchronize()
    _build.check(read(counts, 0), variant)
    passed, merged, heavy = (int(c) for c in counts)
    return {"passed": passed, "passed_share": passed / (ROWS * n),
            "merges_per_row_split": merged / (ROWS * splits),
            "heavy_per_row_split": heavy / (ROWS * splits)}


def sweep(preset: str, bits_list=(4,), seed: int = 0) -> None:
    libs = _build.build_variants("topk_fused", PRESETS[preset])
    gen = torch.Generator().manual_seed(seed)
    bf16, ptr, dev = torch.bfloat16, _build.ptr, "cuda"
    x = torch.randn(ROWS, K, generator=gen).to(dev)
    for bits in bits_list:
        for kind, p in generators(bits, gen).items():
            n = p.shape[1]
            rv, ri, rlse = dequant_matmul_topk_reference(x, p, K_TOP, compute_dtype=bf16)
            w16 = dequantize_linear(p, bf16)

            def library():
                logits = torch.matmul(x.to(bf16), w16).float() + p.bias
                return torch.topk(logits, K_TOP), torch.logsumexp(logits, dim=-1)

            row = {"generator": kind, "M": ROWS, "K": K, "N": n, "bits": bits, "k": K_TOP,
                   "library_us": graph_ms(library) * 1e3}
            for variant, lib in libs.items():
                plan = (ctypes.c_int * len(_PLAN_KEYS))()
                _build.check(_build.bind(lib, "qdt_topk_fused_plan", _PLAN_ARGTYPES)(
                    ROWS, K, n, 0, 1, int(p.points is not None), bits, plan), variant)
                plan = dict(zip(_PLAN_KEYS, plan))
                fn = _build.bind(lib, "qdt_topk_fused", _ARGTYPES)
                splits = plan["splits"]
                part_v = torch.empty(ROWS, splits, KMAX, device=dev)
                part_i = torch.empty(ROWS, splits, KMAX, dtype=torch.int32, device=dev)
                part_m = torch.empty(ROWS, splits, device=dev)
                part_s = torch.empty(ROWS, splits, device=dev)
                v = torch.empty(ROWS, K_TOP, device=dev)
                i = torch.empty(ROWS, K_TOP, dtype=torch.int32, device=dev)
                lse = torch.empty(ROWS, 1, device=dev)

                def call(fn=fn, plan=plan, variant=variant):
                    _build.check(fn(ptr(x), 0, 1, ptr(p.packed), ptr(p.scale), ptr(p.offset),
                                    ptr(p.points), ptr(p.bias), ROWS, K, n, p.n_padded, bits,
                                    K_TOP, plan["tiles_per_split"], plan["splits"], ptr(part_v),
                                    ptr(part_i), ptr(part_m), ptr(part_s), ptr(v), ptr(i),
                                    ptr(lse), _build.stream()), variant)

                call()
                match = bool(torch.allclose(v, rv, rtol=1e-4, atol=1e-4)
                             and torch.allclose(lse, rlse, rtol=1e-4, atol=1e-4)
                             and torch.equal(i, ri))
                row[variant] = {"us": graph_ms(call) * 1e3, "match": match,
                                "plan": [plan[k] for k in ("BM", "BN", "splits", "blocks",
                                                           "blocks_per_sm")]}
                if preset == "count":
                    row[variant].update(selection_counts(lib, call, variant, n, splits))
            print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", choices=sorted(PRESETS))
    ap.add_argument("--bits", default="4", help="comma-separated: 2, 4, 8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    sweep(args.preset, [int(b) for b in args.bits.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
