"""Helpers the port's parity tests share: carrying a JAX-captured graph
into the port's engine, sharding numpy inputs per rank, evaluating a
graph's defs, float32 agreement to an output's scale, and torch on one
thread. Imports neither JAX nor the JAX package (the graphs arrive as
objects)."""
import contextlib
import itertools
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core.convert import graph_from_obj, relation_from_obj
from repro_torch.core.explain import term_to_obj


def graph_obj(g) -> dict:
    """A graph (either package's) as the plain object ``convert`` reads."""
    return {"inputs": g.inputs, "outputs": g.outputs,
            "defs": [[n, term_to_obj(t)] for n, t in g.defs],
            "shapes": g.shapes, "dtypes": g.dtypes, "consts": g.consts}


def carried(gs, gd, r_i) -> tuple:
    """G_s, G_d and R_i of the JAX package as the port's objects."""
    return (graph_from_obj(graph_obj(gs)), graph_from_obj(graph_obj(gd)),
            relation_from_obj({n: [term_to_obj(t) for t in ts]
                               for n, ts in r_i.items()}))


def outcome(check, err_type, pretty, gs, gd, r_i) -> dict:
    """One engine's verdict, R_o, fires and explanation on a task."""
    try:
        cert = check(gs, gd, r_i, explain=True)
    except err_type as e:
        return {"verdict": "refinement_error", "payload": e.payload(),
                "explanation": e.explanation}
    return {"verdict": "certificate",
            "r_o": [(k, pretty(v, 999)) for k, v in cert.r_o.items()],
            "fires": cert.stats["lemma_fires"],
            "gs_ops": cert.stats["gs_ops"], "gd_ops": cert.stats["gd_ops"],
            "explanation": cert.explanation}


def shard(values, names, specs, mesh_axes) -> dict:
    """Per-rank numpy pieces of the global inputs (``name@tag`` keys)."""
    axes = list(mesh_axes)
    env = {}
    for coords in itertools.product(*(range(mesh_axes[a]) for a in axes)):
        at = dict(zip(axes, coords))
        tag = "@" + ",".join(f"{a}{c}" for a, c in zip(axes, coords))
        for name, spec in zip(names, specs):
            piece = values[name]
            for d, entry in enumerate(tuple(spec)):
                if entry is None:
                    continue
                group = (entry,) if isinstance(entry, str) else entry
                k, n = 0, 1
                for a in group:          # major to minor
                    k, n = k * mesh_axes[a] + at[a], n * mesh_axes[a]
                size = piece.shape[d] // n
                piece = np.take(piece, range(k * size, (k + 1) * size),
                                axis=d)
            env[name + tag] = piece
    return env


def run(graph, env, evaluate) -> dict:
    """``{output: float64 array}`` of ``graph`` evaluated def by def."""
    env = dict(env)
    env.update(graph.consts)
    for name, term in graph.defs:
        env[name] = evaluate(term, env)
    return {o: np.asarray(env[o].numpy() if isinstance(env[o], torch.Tensor)
                          else env[o], dtype=np.float64)
            for o in graph.outputs}


def close_to_scale(got, want, tol=1e-5) -> None:
    """float32 agreement within ``tol`` of the output's scale: the largest
    difference at most ``tol * max(1, max |want|)`` (an elementwise bound
    would sit below float32's resolution on the largest values)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def stable_report_json(report) -> str:
    """A ServeReport's (or a TrainReport's) JSON without what depends on
    time or the worker count: walls, per-phase seconds, pool and runtime
    records."""
    d = json.loads(json.dumps(report.to_json()))
    for k in ("wall_s", "timing", "pool", "workers"):
        d.pop(k, None)
    for nested in d["reports"].values():
        nested.pop("wall_s", None)
        nested.pop("runtime", None)
        for k in ("time_s", "phase_s", "counters"):
            (nested.get("stats") or {}).pop(k, None)
    return json.dumps(d, sort_keys=True)


def report_fires(report) -> dict:
    """{obligation key: lemma fires} of a report's nested reports."""
    return {k: (r.get("stats") or {}).get("lemma_fires")
            for k, r in report.reports.items()}



ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread for the block, and ``OMP_NUM_THREADS=1``
    for the processes it starts (pool workers, interpreters). Tier-1 runs
    six pytest workers on the machine's cores, where torch's default of a
    thread a core makes small ops wait on each other: 29 steps of the
    reduced gpt take ~1 s on one thread and ~47 s on eight beside five busy
    processes, and six of the port's test files, on six workers, 1812 s
    summed on the default threads against 652 s on one (an 8-core CPU)."""
    n = torch.get_num_threads()
    saved = {k: os.environ.get(k) for k in ONE_THREAD_ENV}
    torch.set_num_threads(1)
    os.environ.update(ONE_THREAD_ENV)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(autouse=True, scope="module")
def one_thread_module():
    """Each port test module on one thread (``one_thread``); a module
    takes it by importing this fixture."""
    with one_thread():
        yield
