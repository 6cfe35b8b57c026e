"""What every path shares: the cell as ``BENCHMARK.json`` and its files
define it, the measured window, the result line and its checks.

A path (``portbench/paths/<name>.py``) exposes ``run(cell, seed, seconds,
trace, device, started, control=None) -> Outcome``. It builds the system under test from the
cell's files, warms up every shape the cell's traffic uses, measures for
``seconds``, and then, with the program's state freed, holds what the
timed path produced against the plain reference (``portbench.reference``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "quantized_distillation_tpu")


@dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files."""

    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    peaks: dict


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``: its configuration
    file, its mix ``portbench/traffic/<traffic>.json``, its limits
    ``portbench/limits/<cell>.json``, and the metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
    return Cell(name=workload, config=_json(root / config_file),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{workload}.json"), chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer, peaks=_json(HERE / "peaks.json"))


@dataclass
class Outcome:
    """What a path's run gives the result line. ``rates`` are the cell's
    end-to-end metrics besides ``setup_s``; ``checks`` each compared number
    as (name, reading, limit); ``record`` the traced window's record
    (``portbench.trace``) with the path's ``units`` and ``unit_shapes``;
    ``notes`` what a reading is looked into by, and the control's readings
    where a run was asked for them; ``loaded`` the modules of JAX or the
    JAX package that another process of the run (a rank) held once its
    window had closed."""

    setup_s: float
    rates: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Tuple[str, float, float]]
    cards: int = 1
    record: Optional[dict] = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    notes: Dict[str, object] = field(default_factory=dict)
    loaded: List[str] = field(default_factory=list)


def correct(outcome: Outcome) -> bool:
    """Every compared number within its limit, and no request failed."""
    return bool(outcome.checks) and outcome.failed == 0 and all(
        v <= lim for _, v, lim in outcome.checks)


def per_layer(cell: Cell, rec: dict) -> Dict[str, float]:
    """Each of the cell's per-layer metrics that its reader
    (``portbench/metrics/<name>.py``, ``read(record) -> float or None``)
    finds something to read for."""
    out = {}
    for m in cell.per_layer:
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(rec)
        if value is not None:
            out[m["name"]] = float(value)
    return out


def loaded_forbidden() -> List[str]:
    """Modules whose top-level name is JAX, its companions or the JAX
    package, compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def result_line(cell: Cell, outcome: Outcome, trace: bool, device: dict) -> dict:
    """The contract's last line. The checks come last, each with its limit."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = per_layer(cell, outcome.record)
    else:
        values = dict(outcome.rates, setup_s=outcome.setup_s)
    line = {
        "correct": correct(outcome),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": dict(device),
    }
    if trace:
        from .trace import breakdown

        line["device"].update(busy_s=outcome.busy_s, window_s=outcome.window_s)
        line["breakdown"] = breakdown(outcome.record)
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    return line
