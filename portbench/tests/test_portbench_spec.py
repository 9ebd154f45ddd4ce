"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has the file that the harness finds it by."""
import json
import re

import pytest

from portbench import bench

SPEC = bench.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in SPEC["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    # a full check of 24 cells fits the driver's day
    assert 1200 + 24 * (14 * (SPEC["run_seconds"] + 60) + 2 * 90) <= 43200


def test_names_units_and_files():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert bench.reader_path(m["name"]).is_file()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = bench.load_json(bench.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (bench.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (bench.HERE / "limits" / f"{w['name']}.json").is_file()


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    c = bench.find_cell(SPEC, cell)
    e2e = [m["name"] for m in bench.metric_names(SPEC, c, False)]
    layer = bench.metric_names(SPEC, c, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert any("mfu" in m["name"].split(".")[0].split("_") for m in layer)
    for m in layer:
        assert m["moves"] in e2e


def test_per_layer_moves_an_end_to_end_metric():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert "K2 forward" in layers


def test_a_kind_suffix_shares_one_reader():
    assert bench.reader_path("step_mfu.train") == \
        bench.reader_path("step_mfu.prefill") == \
        bench.HERE / "metrics" / "step_mfu.py"
    assert bench.reader_path("k1_roofline").name == "k1_roofline.py"
