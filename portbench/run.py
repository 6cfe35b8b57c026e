"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics read from a profiler window
over the first units of the measured window, with the device's busy and
window seconds and the breakdown. Either way the run holds what the timed
path produced against the plain reference and prints each compared number
beside its limit: as the last lines on standard error, and under
``checks``, last, in the result line, which is the last line on standard
output. The run exits non-zero and prints no result line without enough
CUDA devices, or if JAX or the JAX package was loaded, in this process
or in any rank of a run across cards.

Kernel caches stay in the checkout: the port builds its kernels into
``quantized_distillation_tpu_torch/_build/`` (keyed by a hash of the
sources), and Triton's and PyTorch's kernel caches go under
``.portbench_cache/``.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .harness import ROOT, load_cell, loaded_forbidden, result_line  # noqa: E402

CACHE = ROOT / ".portbench_cache"


def _caches() -> None:
    """Kernel caches at fixed paths in the checkout, and one host thread for
    the CPU's math libraries (torch is imported after this), so that no
    idle worker spins beside the thread that feeds the card."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    _caches()
    cell = load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    path = importlib.import_module(f"portbench.paths.{cell.traffic['path']}")
    outcome = path.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    found = loaded_forbidden() + outcome.loaded
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": outcome.cards,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = result_line(cell, outcome, bool(args.trace), device)
    for name, text in outcome.notes.items():
        print(f"look {name}: {text}", file=sys.stderr)
    for name, v, lim in outcome.checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
