"""The harness finds every configuration, workload, traffic kind,
reference and per-layer metric that BENCHMARK.json names, by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest

from conftest import ROOT
from kgbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    w = harness.load_json("workloads", cell)
    assert (w["config"], w["traffic"]) == (entry["config"], entry["traffic"])
    cfg = harness.load_json("configs", w["config"])
    assert cfg["source"] == {c["name"]: c for c in BENCH["configs"]}[w["config"]]["source"]
    traffic = harness.load_module("traffic", w["traffic"])
    assert callable(traffic.Session)
    ref = harness.load_module("reference", w["config"])
    assert {"entity", "bt"} <= set(ref.PARAMS(dict(cfg, n_entities=10, n_relations=4)))
    assert set(w["limits"]) and all(v is not None for v in w["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_module("metrics", metric).read)


def test_each_cell_reports_what_the_contract_asks():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(BENCH, w["name"], "end_to_end")]
        per = [m for m in harness.cell_metrics(BENCH, w["name"], "per_layer")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert per and all(m["moves"] in e2e for m in per)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kgbench"] and BENCH["command"][1] == "kgbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("kgbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert "bound" not in m and m["better"] in ("lower", "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
