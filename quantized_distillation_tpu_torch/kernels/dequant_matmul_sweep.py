"""Tile and ablation sweep of the tensor-core dequant-matmul kernel on the card.

    python -m quantized_distillation_tpu_torch.kernels.dequant_matmul_sweep tiles
    python -m quantized_distillation_tpu_torch.kernels.dequant_matmul_sweep ablate [--bits 2,4,8]

Builds variants of ``csrc/dequant_matmul.cu`` that differ from the sources
in ``csrc/`` by the edits of one preset below, each of which replaces one
statement of code (``_build.build_variants``: one ``nvcc`` per variant,
all started together). Nothing in the package imports this module. Then it
times every variant at the decode step's three shapes (student_medium, 1280 rows:
``lstm_0`` and ``lstm_1`` with bf16 x, ``attn_out`` with f32 x; uniform
grid and codebook) with :func:`graph_ms`, beside bf16 ``torch.matmul`` on
the dequantized weight. It prints the card's name and power limit, then one
JSON line per shape: microseconds per call of each variant and whether its
output matches the plain version within the tests' 1e-4. ``tiles`` compares
tile tables (``SHAPES`` and ``pick_shape``'s rule); ``ablate`` takes one
stage of the tile loop out at a time, which shows where the chosen
kernel's time goes (those variants compute something else, so they do not
match). Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..utils.profiling import graph_ms
from . import _build
from .dequant_matmul import _ARGTYPES, dequant_matmul_reference
from .packed import dequantize_linear, pack_linear

_SHAPES = "constexpr Shape SHAPES[] = {{2, 2, 64}, {1, 1, 64}, {1, 1, 32}};"
_RULE = "if (2 * blocks >= tc::sm_count()) return i;"


def _table(shapes: str):
    """Edit: the tile table (warpgroups, 64-row tiles each, columns)."""
    return ("dequant_matmul.cu", _SHAPES, "constexpr Shape SHAPES[] = {" + shapes + "};")


_FIRST_FIT = ("dequant_matmul.cu", _RULE, "return i;")  # the first shape that fits, however few blocks


def _loop(old: str, new: str):
    return ("dequant_tile_tc.cuh", old, new)


_NO_DEQUANT = _loop("transform_b<W>(task, p_stage(st), so_stage(st), lut, table, b_tiles + (s & 1) * W::B_BYTES);", ";")
_NO_MMA = _loop("for (int k16 = 0; k16 < BK / 16; ++k16) {", "for (int k16 = 0; k16 < 0; ++k16) {")
_NO_COPY = [_loop("const bool one = tid == 0;", "const bool one = tid < 0;"),
            _loop("const bool lead = tid == 0;", "const bool lead = tid < 0;"),
            _loop("mbar_wait(&full[st], (s / STAGES) & 1);", ";")]

PRESETS = {
    "tiles": {
        "chosen": [],
        "lstm_128x64": [_table("{2, 1, 64}, {1, 1, 64}, {1, 1, 32}")],
        "lstm_256x32": [_table("{2, 2, 32}, {1, 1, 64}, {1, 1, 32}")],
        "lstm_256x128": [_table("{2, 2, 128}, {1, 1, 64}, {1, 1, 32}"), _FIRST_FIT],
        "ahead_3": [_loop("constexpr int AHEAD = 2;", "constexpr int AHEAD = 3;")],
        "attn_64x32": [_table("{2, 2, 64}, {1, 1, 32}")],
        "attn_128x64": [_table("{2, 2, 64}, {1, 2, 64}"), _FIRST_FIT],
    },
    "ablate": {
        "chosen": [],
        "no_dequant": [_NO_DEQUANT],
        "no_mma": [_NO_MMA],
        "no_dequant_no_mma": [_NO_DEQUANT, _NO_MMA],
        "no_copy": _NO_COPY,
        "no_fence": [_loop("fence_proxy_async();", ";")],
        "no_epilogue": [("dequant_matmul.cu", "if (m >= M || n >= N) continue;",
                         "if (m >= 0) continue;")],
        "one_slab": [_loop("const int S = (K + BK - 1) / BK;", "const int S = 1;")],
        "loop_only": _NO_COPY + [_NO_DEQUANT, _NO_MMA],
    },
}

# (name, K, N, x dtype) of the decode step's matrices (student_medium)
DECODE = (("lstm_0", 768, 1024, torch.bfloat16), ("lstm_1", 512, 1024, torch.bfloat16),
          ("attn_out", 512, 256, torch.float32))
ROWS = 1280  # B = 256 x beam 5


def sweep(preset: str, bits_list=(4,), seed: int = 0) -> None:
    fns = {name: _build.bind(lib, "qdt_dequant_matmul", _ARGTYPES)
           for name, lib in _build.build_variants("dequant_matmul", PRESETS[preset]).items()}
    gen = torch.Generator().manual_seed(seed)
    bf16, ptr = torch.bfloat16, _build.ptr
    for bits in bits_list:
        for lut in (False, True):
            for name, k, n, xdt in DECODE:
                pts = torch.rand(1 << bits, generator=gen) if lut else None
                p = pack_linear(torch.randn(k, n, generator=gen), bits,
                                bias=torch.randn(n, generator=gen), points=pts).to("cuda")
                x = torch.randn(ROWS, k, generator=gen).to("cuda", xdt)
                out = torch.empty(ROWS, n, device="cuda")
                want = dequant_matmul_reference(x, p, compute_dtype=bf16)
                w16 = dequantize_linear(p, bf16)
                row = {"shape": name, "bits": bits, "lut": lut,
                       "library_us": graph_ms(lambda: torch.matmul(x.to(bf16), w16)) * 1e3}
                for variant, fn in fns.items():
                    def call(fn=fn):
                        _build.check(fn(ptr(x), int(xdt == bf16), 1, ptr(p.packed), ptr(p.scale),
                                        ptr(p.offset), ptr(p.points), ptr(p.bias), ptr(out), ROWS,
                                        k, n, p.n_padded, p.bits, _build.stream()), variant)

                    out.zero_()
                    call()
                    match = torch.allclose(out, want, rtol=1e-4, atol=1e-4)
                    row[variant] = [graph_ms(call) * 1e3, match]
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
