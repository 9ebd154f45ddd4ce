"""On the card, at each cell's own size: a short run of every cell comes
out correct, and the float8 control (readings.py's) comes out not correct.
Skips without a card.

    python -m pytest -q -m cuda portbench/tests/test_portbench_cuda.py
"""
import json
import subprocess
import sys

import pytest

from portbench import bench

CELLS = [c["name"] for c in bench.load_bench()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(args):
    r = subprocess.run([sys.executable, *args], cwd=bench.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout.strip().splitlines()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = json.loads(_run(["portbench/run.py", "--workload", cell, "--seed",
                           "5555555555", "--seconds", "3", "--trace", "0"])[-1])
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, tmp_path):
    lines = _run(["portbench/readings.py", "--workload", cell, "--seeds",
                  "6666666666", "--control-seeds", "6666666666",
                  "--seconds", "2", "--out", str(tmp_path / "r.jsonl")])
    rec = json.loads(lines[-1])
    limits = bench.load_json(bench.HERE / "limits" / f"{cell}.json")
    assert rec["correct"], rec["checks"]
    assert any(rec["control"][k] > lim for k, lim in limits.items()), rec
