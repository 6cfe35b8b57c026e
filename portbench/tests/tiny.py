"""Tiny versions of the cells for the CPU tests: the cells' own files with
every size cut down, so that the program's plain versions and the
reference run in seconds."""

from __future__ import annotations

import copy
import json
import time

from portbench import harness

TINY_SEQ2SEQ = {"vocab": 67, "student": {"embed_dim": 16, "hidden": 16, "num_layers": 2},
                "teacher": {"embed_dim": 24, "hidden": 24, "num_layers": 2}}
TINY_LM = {"vocab": 53, "student": {"embed_dim": 16, "hidden": 16, "num_layers": 2},
           "teacher": {"embed_dim": 24, "hidden": 24, "num_layers": 2}}
TINY_BUCKETS = {"batches": 6, "buckets": [4, 8],
                "lengths": {"mean": 5.5, "sigma": 0.5, "min": 2, "max": 8}}
# cells whose path is kept without a cell in BENCHMARK.json: (the cell they
# extend, their mix, their cards)
UNLISTED = {"nmt-kd-train-dp4": ("nmt-kd-train", "wmt-kd-4096tok-x4", 4)}


def _load(workload: str) -> harness.Cell:
    if workload not in UNLISTED:
        return harness.load_cell(workload)
    base, mix, chips = UNLISTED[workload]
    c = harness.load_cell(base)
    with open(harness.HERE / "traffic" / f"{mix}.json") as f:
        c.traffic = json.load(f)
    c.name, c.chips = workload, chips
    return c


def cell(workload: str) -> harness.Cell:
    """The cell ``workload`` at tiny sizes."""
    c = copy.deepcopy(_load(workload))
    tiny = TINY_LM if c.config["family"] == "lm" else TINY_SEQ2SEQ
    for key, value in tiny.items():
        if isinstance(value, dict):
            c.config[key].update(value)
        else:
            c.config[key] = value
    if "serve" in c.config:
        # at 16 wide a bf16 rounding is a larger share of a token's score
        # than at the served widths: the tiny search computes in f32
        c.config["serve"]["compute_dtype"] = "float32"
    if "buckets" in c.traffic:
        c.traffic.update(TINY_BUCKETS)
        if "batch_size" in c.traffic:
            c.traffic["batch_size"] = 4
        else:
            c.traffic["tokens_per_batch"] = 16 * c.chips
        c.traffic["check_sample"] = 8
    else:
        c.traffic.update(batch_size=3, bptt=5, windows=6)
    c.traffic["trace_units"] = 2
    return c


def run(c: harness.Cell, seed: int = 1234567, seconds: float = 0.3, trace: bool = False,
        **kw) -> harness.Outcome:
    import importlib

    path = importlib.import_module(f"portbench.paths.{c.traffic['path']}")
    return path.run(c, seed, seconds, trace, "cpu", time.perf_counter(), **kw)
