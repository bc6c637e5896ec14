"""BENCHMARK.json and the files each cell is found by: every name the
file uses has its configuration, traffic, limits and readers, within the
contract's limits on names and keys. The held-out cell's entries
(``held_out.json``) are held to the same rules."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests import small

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
ALL = small.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in ALL["workloads"]]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(SPEC["command"]) <= 32
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in ALL["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in ALL["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in ALL["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in ALL["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in {e["name"] for e in ALL["end_to_end"]}
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in ALL["end_to_end"] + ALL["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    assert len(CELLS) == len(set(CELLS))
    # what BENCHMARK.json names stands alone: every cell's config and metrics
    configs = {c["name"] for c in SPEC["configs"]}
    assert {w["config"] for w in SPEC["workloads"]} == configs
    held = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", held)) <= held


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = small.load_cell(name)
    assert cell.config["source"] == next(c["source"] for c in ALL["configs"]
                                         if c["name"] == cell.workload["config"])
    assert cell.module("driver").run and cell.module("driver").judge
    if "entry" in cell.traffic:
        assert cell.module("entry").call
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in reported
    assert cell.limits["numbers"]


def test_every_metric_reader_and_cell_file_is_used():
    readers = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in ALL["per_layer"]}
    for kind in ("traffic", "limits"):
        files = {p.name[:-5] for p in (harness.HERE / kind).glob("*.json")}
        assert files == set(CELLS)
    configs = {p.name for p in (harness.HERE / "configs").glob("*.json")}
    assert configs == {c["file"].split("/")[-1] for c in ALL["configs"]}


def test_only_benchmark_json_names_a_cell_that_runs():
    """``benchmark.run`` finds a cell in BENCHMARK.json alone: a held-out
    cell does not load there until an entry of BENCHMARK.json names it."""
    held = {w["name"] for w in harness.entries(small.HELD_OUT)["workloads"]}
    for name in held - {w["name"] for w in SPEC["workloads"]}:
        with pytest.raises(SystemExit):
            harness.load_cell(name)
    for w in SPEC["workloads"]:
        assert harness.load_cell(w["name"]).name == w["name"]
