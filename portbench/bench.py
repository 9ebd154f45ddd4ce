"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, the metrics, the result line.

Everything a cell is made of is found by name: its configuration in
``configs/<config>.json`` (with ``reference/<reference>.py`` beside it),
its mix in ``traffic/<traffic>.json`` (run by ``drivers/<driver>.py``),
each metric in ``metrics/<metric>.py``, the limits of its check in
``limits/<cell>.json``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import counts, mixes

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """What a run knows and what it has measured; drivers and metric
    readers read and fill it."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, config_override=None,
                 mix_override=None, entry=None, bench=None):
        self.bench = bench if bench is not None else load_bench()
        self.cell = cell
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.config = load_json(HERE / "configs" / f"{cell['config']}.json")
        if config_override:
            self.config.update(config_override)
        self.mix = mixes.load(cell["traffic"])
        if mix_override:
            self.mix.update(mix_override)
        self.reference = importlib.import_module(
            f"portbench.reference.{self.config['reference']}")
        self.layout = self.reference.layout(self.config)
        self.limits = load_json(HERE / "limits" / f"{cell['name']}.json")
        # a fault planted for a test: wraps the program's timed entry
        self.entry = entry or (lambda fn: fn)
        self.records = []          # the window's steps or requests
        self.window_s = None
        self.setup_s = None
        self.memory_peak_bytes = None
        self.stretch = None        # the traced stretch (drivers.trace)
        self.checks = []           # (name, value, limit)
        self.attempted = self.failed = 0
        self.control = False       # portbench/readings.py reads the control
        self.readings = {}
        self.device_name = torch.cuda.get_device_name(0) \
            if self.device.type == "cuda" else "cpu"

    # -- the program's configuration -----------------------------------
    def port_config(self):
        """The program's ``ModelConfig``: its registry entry with the
        file's ``port.fields`` replaced."""
        from repro_torch.models import registry
        port = self.config["port"]
        return dataclasses.replace(registry.load_config(port["arch"]),
                                   **port["fields"])

    @property
    def peaks(self) -> dict:
        return counts.peaks_for(self.device_name)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in bench['workloads']]}")


def metric_names(bench: dict, cell: dict, trace: bool) -> list:
    """The metrics a run of ``cell`` reports. With ``--trace 0`` the
    end-to-end ones, with ``--trace 1`` the per-layer ones; a metric with a
    ``workloads`` list only in the cells it names, and a per-layer metric
    without one in every cell that reports the end-to-end metric it
    ``moves``."""
    def here(m):
        return cell["name"] in m.get("workloads", [cell["name"]])
    if not trace:
        return [m for m in bench["end_to_end"] if here(m)]
    reported = {m["name"] for m in bench["end_to_end"] if here(m)}
    return [m for m in bench["per_layer"]
            if here(m) and ("workloads" in m or m["moves"] in reported)]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``; where there is none, the reader of the name
    less its last ``.<kind>`` suffix (``step_mfu.train`` and
    ``step_mfu.prefill`` both read ``metrics/step_mfu.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        return reader_path(name.rsplit(".", 1)[0])
    return path


def metric_reader(name: str):
    """The reader of metric ``name`` (``reader_path``), loaded by its
    path."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + path.stem.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(run: Run):
    return importlib.import_module(f"portbench.drivers.{run.mix['driver']}")


def free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class fp32_products:
    """TF32 off for the reference's float32 products; restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, prec) = self.saved
        torch.set_float32_matmul_precision(prec)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(run: Run) -> dict:
    """Set-up, window, (trace), check; returns the result object."""
    drv = driver(run)
    state = drv.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - run.t_start
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    gc.collect()
    gc.disable()                   # no collector pauses inside the window
    try:
        drv.window(run, state)
    finally:
        gc.enable()
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    if run.trace:
        drv.trace(run, state)
    t_check = time.perf_counter()
    drv.check(run, state)
    run.check_s = time.perf_counter() - t_check
    del state
    free_device()
    metrics = {}
    for m in metric_names(run.bench, run.cell, run.trace):
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # after every reader has run: the process that prints the result
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules that must not load were loaded: {found}")
    correct = all(v <= lim for _, v, lim in run.checks) and bool(run.checks)
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": run.device_name, "count": run.cell["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.stretch:
        device["busy_s"] = run.stretch["busy_s"]
        device["window_s"] = run.stretch["window_s"]
        out["breakdown"] = run.stretch["breakdown"]
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in run.checks}
    return out
