"""Readings from which a cell's limits are set: for each seed, one run of
the cell at its own size with a short window, the program's compared
numbers, and the control's (the reference in the program's place, one
precision below the configuration's) on the same inputs; a training cell
also reads the half-batch fault planted in the reference. One process, so
the set-up's libraries load once.

    python3 -m portbench.calibrate --workload <cell> --control <fmt> --seeds 1 2 3 --seconds 2

prints one JSON line a seed and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from .harness import load_cell, loaded_forbidden
from .run import _caches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", required=True, help="tf32 or fp8 (reference.numerics)")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    _caches()
    import torch

    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    path = importlib.import_module(f"portbench.paths.{cell.traffic['path']}")
    rows, found = [], set()
    for seed in args.seeds:
        t = time.perf_counter()
        o = path.run(cell, seed, args.seconds, False, "cuda", t, control=args.control)
        row = {"seed": seed, "program": {k: v for k, v, _ in o.checks}, "control": o.notes,
               "rates": o.rates, "setup_s": o.setup_s, "failed": o.failed,
               "seconds": time.perf_counter() - t}
        rows.append(row)
        found.update(o.loaded)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    found.update(loaded_forbidden())
    if found:
        print(f"modules of JAX or the JAX package were loaded: {sorted(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
