"""Training mixes: a closed loop of one client, through
``repro_torch.train.make_train_step``: each step accumulates the gradient
of the mix's ``microbatches`` fresh batches (the program's own
accumulation, ``TrainConfig.microbatches``), then AdamW updates once.

Set-up makes the weights from the seed, builds the step and its AdamW
state, and drives it through the mix's first ``checked_steps`` steps on
batches of the window's own feed (rows that all differ). Those steps warm
up the step's one shape, and their readings are what the check holds
against the reference: each step's loss; the first gradient by leaf as
the optimizer got it (its first moment after one step over 1 - b1): its
norm and its elements at a sample drawn from the seed (the input
embedding's in whole rows, by microbatch and band of positions); and by
leaf the parameters' change over the steps. The same objects then run the
window.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from .. import mixes, trace as tracing, weights
from ..bench import fp32_products, free_device


class State:
    pass


def _opt_config(run):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import TrainConfig
    return TrainConfig(optimizer=AdamWConfig(**run.mix["optimizer"]),
                       microbatches=run.mix["microbatches"])


def rows(mix) -> int:
    """Sequences a step takes: the microbatches times their batch."""
    return mix["microbatches"] * mix["batch"]


def _batch(run, st):
    return mixes.train_batch(st.data, rows(run.mix), run.mix["seq"],
                             run.config["vocab_size"], run.device)


def setup(run) -> State:
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    st = State()
    cfg = run.port_config()
    st.tcfg = _opt_config(run)
    model = registry.build_model(cfg, "meta")
    flat, views = weights.make(run.layout, mixes.sub_seed(run.seed, "weights"),
                               run.device, cfg.torch_dtype)
    weights.bind(model, views)
    for p in model.parameters():
        p.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = adamw.init(params)
    st.step = run.entry(make_train_step(cfg, st.tcfg))
    st.data = torch.Generator(device=run.device).manual_seed(
        mixes.sub_seed(run.seed, "data"))
    first = flat.clone()
    b1 = st.tcfg.optimizer.b1
    losses, grad_norms = [], None
    for i in range(run.mix["checked_steps"]):
        batch = _batch(run, st)
        model, opt, m = st.step(model, opt, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            norms = torch.stack([torch.linalg.vector_norm(opt["mu"][n])
                                 for n in params]) / (1 - b1)
            grad_norms = dict(zip(params, norms.tolist()))
            pick = picker(sample_indices(run, batch["tokens"]))
            where = once(batch["tokens"])[1]
            grad_sample = {n: (pick(n, opt["mu"][n]) / (1 - b1)).cpu()
                           for n in params}
    offs, _ = weights.offsets(run.layout, flat.dtype)
    before = {n: first[o:o + views[n].numel()] for n, (o, _) in offs.items()}
    change = torch.stack([torch.linalg.vector_norm(
        params[n].detach().float().flatten() - before[n].float())
        for n in params])
    st.first = dict(losses=losses, grad_norms=grad_norms,
                    change_norms=dict(zip(params, change.tolist())),
                    grad_sample=grad_sample)
    st.where = where
    del first, before, change
    st.model, st.opt, st.flat = model, opt, flat
    free_device()
    return st


def window(run, st):
    """Steps until the window's seconds have passed; each timed from its
    call to its synchronised result."""
    losses = []
    t_start = time.perf_counter()
    while True:
        batch = _batch(run, st)
        t0 = time.perf_counter()
        st.model, st.opt, m = st.step(st.model, st.opt, batch)
        run.sync()
        t1 = time.perf_counter()
        losses.append(m["loss"])
        run.records.append(dict(t0=t0, t1=t1,
                                seqs=[run.mix["seq"]] * rows(run.mix)))
        if t1 - t_start >= run.seconds:
            break
    run.window_s = run.records[-1]["t1"] - t_start
    run.attempted = len(losses)
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum())


def trace(run, st):
    """The profiled stretch: ``trace_steps`` steps, one profiler
    session."""
    def one():
        st.model, st.opt, _ = st.step(st.model, st.opt, _batch(run, st))
    run.stretch = tracing.profile(run, one, run.mix["trace_steps"],
                                  [run.mix["seq"]] * rows(run.mix))


SAMPLE = 1 << 16     # elements a leaf's first gradient is compared at
BAND = 128           # positions a band of the embedding's rows groups


def sample_indices(run, tokens) -> dict:
    """By leaf, what of the first gradient the check compares: all of a
    leaf of SAMPLE elements or fewer, else SAMPLE flat indices drawn (with
    replacement) from the seed; for the input embedding, the rows (token
    ids) that occur once in the first step's ``tokens`` (microbatches x
    batch, S), each the gradient of one position of one sequence, in the
    order of their (sequence, position)."""
    g = torch.Generator().manual_seed(mixes.sub_seed(run.seed, "sample"))
    out = {}
    for name, shape, _ in run.layout:
        n = math.prod(shape)
        if name == "embed":
            out[name] = once(tokens)[0].to(run.device)
        elif n <= SAMPLE:
            out[name] = torch.arange(n, device=run.device)
        else:
            out[name] = torch.randint(0, n, (SAMPLE,), generator=g).to(
                run.device)
    return out


def once(tokens):
    """``(ids, (rows, bands))``: the ids that occur once in ``tokens``
    (R, S), in the order of their (row, position), and each one's row and
    band of BAND positions."""
    flat = tokens.reshape(-1).cpu()
    counts = torch.bincount(flat)
    where = torch.nonzero(counts[flat] == 1)[:, 0]
    S = tokens.shape[1]
    return flat[where], (where // S, (where % S) // BAND)


def picker(sample: dict):
    """``pick(name, t)``: the embedding's sampled rows, another leaf's
    sampled elements."""
    def pick(name, t):
        idx = sample[name]
        return t[idx] if name == "embed" else t.flatten()[idx]
    return pick


def row_gaps(prog, ref):
    """By sampled embedding row, |program - reference| over |reference|."""
    p, r = (x.float().cpu() for x in (prog, ref))
    return torch.linalg.vector_norm(p - r, dim=1) \
        / torch.linalg.vector_norm(r, dim=1).clamp(min=1e-30)


def gap(prog: dict, ref: dict, leaves) -> float:
    """The worst leaf's gap between the two norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in leaves)


def worst_median(gaps, groups) -> float:
    """The largest of the groups' median gaps."""
    return max(float(gaps[groups == k].median())
               for k in torch.unique(groups))


def compare(prog: dict, ref: dict, where) -> dict:
    """The numbers the check compares: the worst step's relative loss gap,
    the first gradient's worst leaf, the change's worst leaf over the
    leaves whose reference gradient is at least a thousandth of the median
    leaf's (the others move by round-off alone); the embedding's rows
    (one position each; ``where``: each row's sequence and band of BAND
    positions): their median gap, their 90th percentile, the worst
    (sequence, band)'s median, and the worst band's median over every
    sequence."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moved = [n for n in g if g[n] >= 1e-3 * med]
    rel = {}
    for n in moved:
        if n == "embed":
            continue
        p, r = (x["grad_sample"][n].float().cpu() for x in (prog, ref))
        rel[n] = float(torch.linalg.vector_norm(p - r)
                       / torch.linalg.vector_norm(r).clamp(min=1e-30))
    gaps = row_gaps(prog["grad_sample"]["embed"], ref["grad_sample"]["embed"])
    seqs, bands = where
    return {"loss": loss, "grad_norm": gap(prog["grad_norms"], g, g),
            "change_norm": gap(prog["change_norms"], ref["change_norms"],
                               moved),
            "grad_diff_max": max(rel.values()),
            "grad_diff_median": statistics.median(rel.values()),
            "embed_row_diff_median": float(gaps.median()),
            "embed_row_diff_p90": float(torch.quantile(gaps, 0.9)),
            "embed_band_diff_max": worst_median(
                gaps, seqs * (int(bands.max()) + 1) + bands),
            "embed_pos_band_diff_max": worst_median(gaps, bands)}


def reference_readings(run, precision="float32", half_labels=False) -> dict:
    """The reference's checked steps on the seed's weights and batches,
    each step's batch in the mix's microbatches."""
    _, views = weights.make(run.layout, mixes.sub_seed(run.seed, "weights"),
                            run.device, run.port_config().torch_dtype)
    data = torch.Generator(device=run.device).manual_seed(
        mixes.sub_seed(run.seed, "data"))
    batches = []
    for _ in range(run.mix["checked_steps"]):
        b = mixes.train_batch(data, rows(run.mix), run.mix["seq"],
                              run.config["vocab_size"], run.device)
        if half_labels:
            b["labels"][:, b["labels"].shape[1] // 2:] = -1
        batches.append(b)
    with fp32_products():
        return run.reference.train_steps(
            views, run.config, batches, run.mix["optimizer"],
            run.port_config().torch_dtype, precision,
            picker(sample_indices(run, batches[0]["tokens"])),
            run.mix["microbatches"])


def check(run, st):
    """Frees the program's state, then runs the reference's steps and
    compares."""
    prog = st.first
    st.model = st.opt = st.step = st.flat = None
    free_device()
    ref = reference_readings(run)
    run.readings = dict(program=prog, reference=ref)
    numbers = compare(prog, ref, st.where)
    run.readings["numbers"] = numbers
    for name, limit in run.limits.items():
        run.checks.append((name, numbers[name], limit))
    run.checks.append(("nonfinite_losses", float(run.failed), 0.0))
    if run.control:
        # the control (the reference's products in float8) and the
        # half-batch fault, planted in the reference put in the program's
        # place; read by portbench/readings.py, never by a run
        free_device()
        run.readings["control"] = compare(
            reference_readings(run, "float8"), ref, st.where)
        free_device()
        run.readings["half_batch"] = compare(
            reference_readings(run, half_labels=True), ref, st.where)
