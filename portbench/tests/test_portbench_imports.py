"""No module that the harness or the reference loads has the top-level
name ``jax`` or ``repro`` (compared whole: ``repro_torch`` is the program),
and the reference loads nothing of the program."""
import json
import subprocess
import sys
import types

import pytest

from portbench import bench
from portbench.tests.tiny import tiny_run

LOADED = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
{body}
print(json.dumps(sorted(sys.modules)))
"""

HARNESS = """
import time, torch
torch.set_num_threads(1)
from portbench import bench, readers, readings, run, trace
from portbench.tests.tiny import tiny_run
for cell in ("mixtral-train-4k", "yi9b-prefill-mix"):
    r = tiny_run(cell, seconds=0.1)
    bench.run_cell(r)
import importlib, pkgutil, portbench.drivers
for m in pkgutil.iter_modules(portbench.drivers.__path__):
    importlib.import_module(f"portbench.drivers.{m.name}")
for f in (bench.HERE / "metrics").glob("*.py"):
    bench.metric_reader(f.stem)
"""

REFERENCE = """
import torch
torch.set_num_threads(1)
from portbench import counts, mixes, weights
from portbench.reference import decoder
c = json.load(open({cfg!r}))
c.update(hidden_size=32, intermediate_size=48, num_attention_heads=4,
         num_key_value_heads=2, head_dim=8, vocab_size=64)
_, w = weights.make(decoder.layout(c), 1, "cpu", torch.float32)
b = {{"tokens": torch.zeros(1, 8, dtype=torch.long),
      "labels": torch.ones(1, 8, dtype=torch.long)}}
decoder.train_steps(w, c, [b], mixes.load("train-4k")["optimizer"],
                    torch.float32)
"""


def loaded(body):
    code = LOADED.format(src=str(bench.ROOT / "src"), root=str(bench.ROOT),
                         body=body)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=bench.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return {m.split(".")[0] for m in json.loads(r.stdout.splitlines()[-1])}


def test_harness_loads_no_jax_and_no_jax_package():
    tops = loaded(HARNESS)
    assert "repro_torch" in tops          # it does drive the program
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    cfg = str(bench.HERE / "configs" / "mixtral-8x7b-2L.json")
    tops = loaded(REFERENCE.format(cfg=cfg))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_modules_compares_whole_top_level_names():
    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro_torch_lookalike" not in bench.forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_lookalike", None)


def test_a_reader_that_loads_the_jax_package_leaves_no_result(monkeypatch):
    """The check runs after every metric reader: one that loads a module
    named ``repro`` (a stub here) makes the run refuse."""
    stub = types.ModuleType("repro")

    class Reader:
        @staticmethod
        def read(run):
            monkeypatch.setitem(sys.modules, "repro", stub)
            return 1.0
    monkeypatch.setattr(bench, "metric_reader", lambda name: Reader)
    with pytest.raises(SystemExit, match="repro"):
        bench.run_cell(tiny_run("yi9b-prefill-mix", seconds=0.1))
