"""The port's spans beside the benchmark's record, on synthetic kineto-like
events: a window, the benchmark's ``portbench.step`` spans and their
device mirrors, host runtime calls, kernels and idle gaps, with and
without the port's ``qdt.`` spans.

The port's spans are host events only (function scope, no device mirror),
so every key of ``trace.record`` but ``idle_gaps`` reads the same with
them, and ``idle_gaps`` keeps its total and relabels only gaps that no
operator or runtime call covered; a user-scope span's device mirror would
have counted as device work. ``program.reduce`` gives ``program_spans``,
``idle_by_span`` (innermost span at each gap's middle) and ``counters``,
and each reader of ``program.ENTRIES`` the hand-computed value, or None
on a record without them."""

import importlib.util
import json
import types
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType

from portbench import program, trace

HERE = Path(__file__).resolve().parent.parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


class Event:
    def __init__(self, name, start, end, device=DeviceType.CPU):
        self._v = (name, start, end, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


def prof(events):
    results = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


CUDA = DeviceType.CUDA
# window [0, 1000] ns; kernels leave gaps [100, 300], [600, 800], [900, 1000]
BASE = [
    Event(trace.WINDOW, 0, 1000),
    Event("portbench.step", 40, 945),
    Event("portbench.step", 40, 945, CUDA),  # the benchmark span's device mirror
    Event("aten::copy_", 70, 80),
    Event("cudaGraphLaunch", 160, 240),
    Event("k1", 0, 100, CUDA),
    Event("Memcpy HtoD", 300, 350, CUDA),
    Event("k2", 340, 600, CUDA),
    Event("k3", 800, 900, CUDA),
]
QDT = [
    Event("qdt.train.step", 50, 940),
    Event("qdt.train.prepare", 60, 150),
    Event("qdt.graph.replay", 150, 250),
    Event("qdt.train.finish", 650, 750),
]
BEFORE = {"graph.replays": 5, "graph.captures": 2, "launch.fake_quant_buckets": 10}
AFTER = {"graph.replays": 17, "graph.captures": 2, "launch.fake_quant_buckets": 34,
         "graph.evictions": 0}


def test_record_reads_the_same_with_the_port_spans():
    base, spanned = trace.record(prof(BASE)), trace.record(prof(BASE + QDT))
    assert set(base) == set(spanned)
    for key in ("window_s", "busy_s", "ops", "spans"):
        assert spanned[key] == base[key], key
    assert base["busy_s"] == pytest.approx(500e-9)
    assert sum(spanned["idle_gaps"].values()) == pytest.approx(sum(base["idle_gaps"].values()))
    # the gap under the graph launch keeps its label; the one where only the
    # port's span covered the host is named by it
    assert base["idle_gaps"] == pytest.approx(
        {"step/cudaGraphLaunch": 200e-9, "step": 200e-9, "host idle": 100e-9})
    assert spanned["idle_gaps"] == pytest.approx(
        {"step/cudaGraphLaunch": 200e-9, "step/qdt.train.finish": 200e-9, "host idle": 100e-9})
    assert trace.breakdown(spanned)["device_ops"] == trace.breakdown(base)["device_ops"]


def test_a_device_mirror_would_count_as_device_work():
    mirrored = trace.record(prof(BASE + QDT + [Event("qdt.train.step", 50, 940, CUDA)]))
    assert mirrored["busy_s"] > trace.record(prof(BASE))["busy_s"]
    assert "qdt.train.step" in mirrored["ops"]
    # the program's reduction skips such a mirror all the same
    assert program.reduce(prof(BASE + QDT + [Event("qdt.train.step", 50, 940, CUDA)])) == \
        program.reduce(prof(BASE + QDT))


def test_reduce():
    got = program.reduce(prof(BASE + QDT), BEFORE, AFTER)
    want = {"train.step": (50, 940), "train.prepare": (60, 150), "graph.replay": (150, 250),
            "train.finish": (650, 750)}
    assert set(got["program_spans"]) == set(want)
    for name, (s, e) in want.items():
        (span,) = got["program_spans"][name]
        assert span == pytest.approx([s * 1e-9, e * 1e-9]), name
    # gap middles 200 (graph.replay, innermost of step), 700 (finish), 950 (none)
    assert got["idle_by_span"] == pytest.approx(
        {"graph.replay": 200e-9, "train.finish": 200e-9, program.OUTSIDE: 100e-9})
    assert got["counters"] == {"graph.replays": 12, "launch.fake_quant_buckets": 24}
    assert "counters" not in program.reduce(prof(BASE + QDT))


def test_reduce_without_the_port_spans():
    got = program.reduce(prof(BASE))
    assert got["program_spans"] == {}
    assert got["idle_by_span"] == pytest.approx({program.OUTSIDE: 500e-9})


def test_reduce_needs_the_window():
    with pytest.raises(RuntimeError, match="window"):
        program.reduce(prof(QDT))


def reader(name):
    spec = importlib.util.spec_from_file_location(name, HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _train_rec():
    rec = trace.record(prof(BASE + QDT))
    rec.update(program.reduce(prof(BASE + QDT), BEFORE, AFTER), units=1)
    return rec


SERVE = {  # two searches over a 1 ms window, as program.reduce leaves them
    "window_s": 1e-3, "units": 2,
    "program_spans": {"serve.search": [[0.0, 3e-4], [5e-4, 9e-4]],
                      "graph.inputs": [[1e-4, 1.2e-4], [6e-4, 6.2e-4]],
                      "graph.replay": [[1.2e-4, 2.2e-4], [6.2e-4, 8e-4], [9.5e-4, 9.9e-4]],
                      "graph.capture": [[9.4e-4, 9.99e-4]]},
    "idle_by_span": {"graph.replay": 5e-5, "serve.search": 1e-5, program.OUTSIDE: 2e-5},
    "counters": {"graph.replays": 3, "graph.captures": 1},
}

WANT = {
    "prepare_ms.train": 90e-6, "launch_ms.train": 100e-6,
    "prepare_idle_share.train": 0.0, "launch_idle_share.train": 20.0,
    "graph_replay_ratio.train": 100.0,
    # the third replay lies outside every search: not a search's launch
    "search_host_ms.serve": 1e3 * 7e-4 / 2, "launch_ms.serve": 1e3 * 2.8e-4 / 2,
    "launch_idle_share.serve": 5.0, "graph_replay_ratio.serve": 75.0,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    rec = SERVE if name.endswith(".serve") else _train_rec()
    assert reader(name)(rec) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_the_port_spans(name):
    rec = trace.record(prof(BASE))
    rec.update(units=1)
    assert reader(name)(rec) is None


def test_entries_name_their_readers():
    assert sorted(m["name"] for m in program.ENTRIES) == sorted(WANT)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m.get("workloads") for m in BENCH["end_to_end"]}
    for m in program.ENTRIES:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("program_span", "program_counter")
        assert set(m["workloads"]) <= cells and set(m["workloads"]) <= set(e2e[m["moves"]])
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    names = {m["name"] for m in BENCH["per_layer"]}
    assert not names & set(WANT)  # not in BENCHMARK.json until trace.record adds the keys


def test_a_path_traced_with_the_program_keys():
    """``program._added_to`` on a CPU window around the port's spans and a
    counter: the record gains the spans and the counter's change, and the
    path gets its own functions back."""
    from quantized_distillation_tpu_torch.utils import tracing

    path = types.SimpleNamespace(traced=trace.traced, record=trace.record)
    with program._added_to(path):
        with path.traced(torch.device("cpu")) as p:
            with tracing.span("train.step"), tracing.span("train.prepare"):
                tracing.count("graph.replays", 2)
        rec = path.record(p)
    assert path.traced is trace.traced and path.record is trace.record
    assert set(rec["program_spans"]) == {"train.step", "train.prepare"}
    assert rec["counters"] == {"graph.replays": 2}
    assert rec["busy_s"] == 0.0 and rec["ops"] == {}
