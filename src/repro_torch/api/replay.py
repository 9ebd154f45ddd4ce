"""Numeric replay of a certificate: the executable R_o on real tensors.

``replay(spec)`` draws the task's global inputs from a seeded
``torch.Generator`` on the device, shards them per R_i, evaluates G_d's
defining equations with ``eval_term``, rebuilds the sequential outputs
through the certificate (``Certificate.reconstruct``) and runs the
sequential fragment itself on the same inputs, so the two can be held
together (the JAX package's ``test_certificate_numeric_replay_tp``,
for every case).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core import check_refinement
from ..core.terms import Term, eval_term
from ..models.registry import resolve_device
from .runner import capture_task
from .spec import StrategySpec

SEED = 0        # seed of the input generator
SCALE = 0.3     # inputs are standard normal times SCALE
TOL = 2e-4      # rtol = atol, the JAX package's replay test's tolerance


def shard_inputs(r_i: dict, inputs: Dict[str, torch.Tensor]) -> dict:
    """Per-rank input tensors from global ones: each R_i mapping is a
    nested concat over per-rank tensors, so walking it splits the global
    value into the pieces each rank holds (replicas get the same piece)."""
    env: dict = {}

    def split(t: Term, v: torch.Tensor):
        if t.op == "tensor":
            env[t.name] = v
        elif t.op == "concat":
            sizes = [a.shape[t.attr("dim")] for a in t.args]
            for a, piece in zip(t.args, torch.split(v, sizes,
                                                    dim=t.attr("dim"))):
                split(a, piece)
        else:
            raise ValueError(f"R_i mapping with `{t.op}` is not a sharding")

    for name, exprs in r_i.items():
        for e in exprs:
            split(e, inputs[name])
    return env


def replay(spec: StrategySpec, device=None) -> tuple:
    """``(reconstructed, sequential)``: the G_s outputs rebuilt from G_d's
    values through the certificate, and ``spec.seq_fn`` run on the same
    inputs, as ``{G_s output name: tensor}`` on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for). The inputs are standard normal times
    ``SCALE``, drawn from a generator seeded with ``SEED``. Raises
    ``RefinementError`` when the task has no certificate."""
    dev = resolve_device(device)
    gs, gd, r_i = capture_task(spec, dev)
    cert = check_refinement(gs, gd, r_i)
    g = torch.Generator(device=dev).manual_seed(SEED)
    values = {n: torch.randn(tuple(shape), generator=g, device=dev,
                             dtype=dtype) * SCALE
              for n, (shape, dtype) in zip(spec.input_names, spec.avals)}
    env = dict(gd.consts)
    env.update(shard_inputs(r_i, values))
    for name, term in gd.defs:
        env[name] = eval_term(term, env, dev)
    got = cert.reconstruct(env, dev)
    outs = spec.seq_fn(*(values[n] for n in spec.input_names))
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    want = dict(zip(gs.outputs, outs))
    return got, {k: want[k] for k in got}


def max_rel_excess(got: dict, want: dict) -> float:
    """max over outputs of |got - want| / (TOL + TOL |want|): at most 1
    when every element is within rtol = atol = ``TOL``."""
    worst = 0.0
    for k in want:
        a, b = got[k].double(), want[k].double()
        if a.shape != b.shape:
            raise ValueError(f"{k}: shape {tuple(a.shape)} != "
                             f"{tuple(b.shape)}")
        worst = max(worst, ((a - b).abs() / (TOL + TOL * b.abs()))
                    .max().item())
    return worst
