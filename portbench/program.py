"""The port's own spans and counters in a traced window.

The port marks its layers on the profiler's timeline (``qdt.<name>``
spans, ``quantized_distillation_tpu_torch.utils.tracing``): ``train.step``
around ``train.prepare``, the graph's ``graph.replay`` and
``train.finish``; ``serve.search`` around a search's key, its
``graph.inputs``, ``graph.replay`` and ``graph.outputs``; ``graph.capture``.
They are record functions of the profiler's function scope: host events,
with no range on the device's timeline, so :func:`portbench.trace.record`
reads as it did without them but for ``idle_gaps``, whose label names a
span where no operator or runtime call inside it covers a gap's middle.
Its counters (``graph.captures``, ``graph.replays``, ``graph.evictions``,
``launch.<kernel>``) are read with ``tracing.counts()``.

:func:`reduce` gives the keys that the per-layer readers of :data:`ENTRIES`
read beside the record's own:

- ``program_spans``: span name (without ``qdt.``) → list of
  [start_s, end_s] from the window's start;
- ``idle_by_span``: the window's idle device seconds by the innermost span
  at each gap's middle, ``"outside"`` where there is none;
- ``counters``: each counter's change over the window.

``BENCHMARK.json`` has no entry for these readers yet: ``trace.record``
has to add the keys first (``trace.traced`` taking ``tracing.counts()`` as
the window opens and closes). Until then

    python3 -m portbench.program --workload <cell> --seed <n> --seconds <s>

runs a cell traced, with ``reduce`` added to its record in this process,
and prints its result line with these metrics, the run's ``rates`` and the
record's ``idle_by_span`` and ``counters`` added.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import sys
from typing import Dict, Optional

import numpy as np

from .trace import PREFIX as BENCH_PREFIX
from .trace import WINDOW, _union

PREFIX = "qdt."
OUTSIDE = "outside"

_TRAIN, _SERVE = ["nmt-kd-train", "lm-kd-train"], ["nmt-serve-offline"]
_PREPARE = "train/trainer.py::TrainStep.prepare"
_STEP_REPLAY = "utils/graphs.py::CapturedStep.replay"
_CALL = "utils/graphs.py::CapturedCall"


def _entry(name, unit, better, source, layer, cells):
    moves = "train_tokens_per_s" if cells is _TRAIN else "decode_tokens_per_s"
    return {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
            "moves": moves, "workloads": list(cells)}


# the per-layer entries these readers would have in BENCHMARK.json
ENTRIES = [
    _entry("prepare_ms.train", "ms", "lower", "program_span", _PREPARE, _TRAIN),
    _entry("launch_ms.train", "ms", "lower", "program_span", _STEP_REPLAY, _TRAIN),
    _entry("prepare_idle_share.train", "%", "lower", "program_span", _PREPARE, _TRAIN),
    _entry("launch_idle_share.train", "%", "lower", "program_span", _STEP_REPLAY, _TRAIN),
    _entry("graph_replay_ratio.train", "%", "higher", "program_counter",
           "train/trainer.py::TrainStep's per-signature graphs", _TRAIN),
    _entry("search_host_ms.serve", "ms", "lower", "program_span",
           "serve/infer.py::beam_search_packed", _SERVE),
    _entry("launch_ms.serve", "ms", "lower", "program_span", _CALL, _SERVE),
    _entry("launch_idle_share.serve", "%", "lower", "program_span", _CALL, _SERVE),
    _entry("graph_replay_ratio.serve", "%", "higher", "program_counter",
           "serve/beam.py::SEARCH_GRAPHS", _SERVE),
]


def reduce(prof, before: Optional[Dict[str, int]] = None,
           after: Optional[Dict[str, int]] = None) -> dict:
    """``program_spans``, ``idle_by_span`` and, given the counters at the
    window's ends, ``counters``, from the profiler ``prof`` of a
    ``trace.traced`` window."""
    from torch.autograd import DeviceType

    window, spans, dev = None, [], []
    for e in prof.profiler.kineto_results.events():
        name, start, end = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window = (start, end)
            elif name.startswith(PREFIX):
                spans.append((start, end, name[len(PREFIX):]))
        elif end > start and not name.startswith((BENCH_PREFIX, PREFIX)):
            dev.append((start, end))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    spans = [s for s in spans if s[1] > w0 and s[0] < w1]
    busy = _union(np.array([(max(s, w0), min(e, w1)) for s, e in dev if e > w0 and s < w1],
                           dtype=np.float64).reshape(-1, 2))
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    mids = 0.5 * (gaps[:, 0] + gaps[:, 1])
    # the innermost span at each middle: spans laid on from the longest down
    label = np.full(len(mids), -1)
    for i in sorted(range(len(spans)), key=lambda i: spans[i][0] - spans[i][1]):
        s, e, _ = spans[i]
        label[np.searchsorted(mids, s, "left"):np.searchsorted(mids, e, "right")] = i
    idle: Dict[str, float] = {}
    for i, sec in zip(label, (gaps[:, 1] - gaps[:, 0]) * 1e-9):
        key = spans[i][2] if i >= 0 else OUTSIDE
        idle[key] = idle.get(key, 0.0) + float(sec)
    program_spans: Dict[str, list] = {}
    for s, e, name in sorted(spans):
        program_spans.setdefault(name, []).append([(s - w0) * 1e-9, (e - w0) * 1e-9])
    out = {"program_spans": program_spans, "idle_by_span": idle}
    if before is not None and after is not None:
        out["counters"] = {k: v - before.get(k, 0) for k, v in after.items()
                           if v != before.get(k, 0)}
    return out


# ------------------------------------------------------------ readers' helpers


def span_ms(rec: dict, name: str, inside: Optional[str] = None) -> Optional[float]:
    """Host milliseconds a traced unit in the spans ``name`` (only those
    inside a span ``inside``, when given): their total over the units."""
    spans = rec.get("program_spans", {}).get(name, [])
    if inside is not None:
        outer = rec.get("program_spans", {}).get(inside, [])
        spans = [(s, e) for s, e in spans if any(o0 <= s and e <= o1 for o0, o1 in outer)]
    return 1e3 * sum(e - s for s, e in spans) / rec["units"] if spans else None


def idle_share(rec: dict, name: str) -> Optional[float]:
    """The window's idle device time under the innermost span ``name``, as
    a share of the window (%); None where the record holds no span."""
    if not rec.get("program_spans"):
        return None
    return 100.0 * rec["idle_by_span"].get(name, 0.0) / rec["window_s"]


def replay_ratio(rec: dict) -> Optional[float]:
    """Graph replays over replays and captures in the window (%)."""
    c = rec.get("counters") or {}
    replays, captures = c.get("graph.replays", 0), c.get("graph.captures", 0)
    return 100.0 * replays / (replays + captures) if replays + captures else None


# ------------------------------------------------------------ running a cell


@contextlib.contextmanager
def _added_to(path):
    """The path module's ``traced`` and ``record`` with the program's keys
    added to the record, for the block."""
    from quantized_distillation_tpu_torch.utils import tracing

    traced, record = path.traced, path.record
    ends = {}

    @contextlib.contextmanager
    def counting(device, ready=None):
        with traced(device, ready) as prof:
            ends["before"] = tracing.counts()
            yield prof
            ends["after"] = tracing.counts()

    def extended(prof):
        rec = record(prof)
        rec.update(reduce(prof, ends.get("before"), ends.get("after")))
        return rec

    path.traced, path.record = counting, extended
    try:
        yield
    finally:
        path.traced, path.record = traced, record


def main(argv=None) -> int:
    from . import run
    from .harness import load_cell, result_line

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    args = p.parse_args(argv)
    run._caches()
    cell = load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    path = importlib.import_module(f"portbench.paths.{cell.traffic['path']}")
    with _added_to(path):
        outcome = path.run(cell, args.seed, args.seconds, True, "cuda", run.STARTED)
    cell = dataclasses.replace(cell, per_layer=cell.per_layer + [
        m for m in ENTRIES if cell.name in m["workloads"]])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": outcome.cards,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = result_line(cell, outcome, True, device)
    rec, checks = outcome.record, line.pop("checks")
    line.update(rates=outcome.rates, idle_by_span=rec["idle_by_span"],
                counters=rec.get("counters", {}), checks=checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
