"""Every cell, configuration, traffic, entry and metric is found by name,
and BENCHMARK.json keeps to its schema."""

import json
import re
import tomllib

import pytest

from benchmark import harness as H

BENCH = H.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = H.cell_of(BENCH, cell)
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (H.ROOT / conf["file"]).is_file()
    traffic = H.HERE / "traffic" / f"{w['traffic']}.toml"
    with open(traffic, "rb") as f:
        t = tomllib.load(f)
    assert (H.HERE / "entries" / f"{t['entry']}.py").is_file()
    assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e, layer = H.metrics_of(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and t["e2e"]["name"] in names
    assert layer, "every cell reports a per-layer metric"
    assert set(t["limits"]), "every cell compares with the reference"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    mod = H.load_module(H.HERE / "metrics" / f"{metric.split('.')[0]}.py",
                        "reader")
    assert mod.read({"units": 1}) is None      # nothing to read: no number
    moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    assert set(m["workloads"]) <= set(moves.get("workloads",
                                                m["workloads"]))


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in BENCH[group]:
            assert NAME.match(x["name"]) and x["name"] not in seen
            seen.add(x["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        with open(H.ROOT / c["file"], "rb") as f:
            meta = tomllib.load(f)["benchmark"]
        assert meta["reduced"] == c["reduced"] and meta["source"]
