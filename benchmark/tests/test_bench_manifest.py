"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and every file a cell needs found by name."""
import json
import os
import re

import pytest

from bench_tiny import BENCH, ROOT, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_names_and_units():
    names = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[sec]:
            assert NAME.match(e["name"]), e["name"]
            names.append((sec, e["name"]))
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len(set(n for _, n in names if _ != "configs")) == len(
        [n for s, n in names if s != "configs"])


def test_every_metric_lists_its_cells_and_what_it_moves():
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    from harness import cell_of

    _, config, mix, driver, e2e, layer = cell_of(M, cell, BENCH)
    for fn in ("setup", "step", "instrument", "release", "verify",
               "counts", "control"):
        assert callable(getattr(driver, fn))
    assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    assert mix["limits"]
