"""BENCHMARK.json keeps to its format, and every name in it finds its files:
names and units of the allowed characters, one configuration file, one mix,
one limits file a cell, one reader a per-layer metric."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("m", METRICS, ids=lambda e: e["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source", "workloads"}
    if m in BENCH["end_to_end"]:
        assert set(m) <= keys | {"bound"} and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert set(m) <= keys | {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((ROOT / c["file"]).read_text())
    assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    assert not any(k.endswith(("_dim", "_rank")) or k == "hidden" for k in c["reduced"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda e: e["name"])
def test_cells(w):
    from portbench.harness import load_cell

    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    cell = load_cell(w["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert (HERE / "paths" / f"{cell.traffic['path']}.py").is_file()
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert {c["name"] for c in BENCH["configs"]} >= {w["config"]}


def test_each_config_used():
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


def test_four_card_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
