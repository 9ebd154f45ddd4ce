"""Prefill mixes: a closed loop of one client, one prompt a request through
``repro_torch.train.serve.prefill_logits``, the next request sent once the
previous one's result is synchronised.

A request's prompt length comes from the mix's fixed set (each cycle in
an order drawn from the seed), its tokens from the seed. The request
returns the greedy token of every position (the argmax of its logits),
which the run keeps. Set-up warms up every length of the set once.

The check: a sample of the finished requests drawn from the seed, the
longest among them; for each position of each, by how much the
reference's logit of the program's token lies below the reference's best
(``summary``: the widest such gap, the mean, the worst band's and
request's means).
"""
from __future__ import annotations

import random
import time

import torch

from .. import mixes, trace as tracing, weights
from ..bench import fp32_products, free_device


class State:
    pass


def _prompt(run, st, S):
    return mixes.token_ids(st.data, (1, S), run.config["vocab_size"],
                           run.device)


def setup(run) -> State:
    from repro_torch.models import registry
    from repro_torch.train.serve import prefill_logits
    st = State()
    cfg = run.port_config()
    model = registry.build_model(cfg, "meta")
    st.flat, views = weights.make(run.layout,
                                  mixes.sub_seed(run.seed, "weights"),
                                  run.device, cfg.torch_dtype)
    weights.bind(model, views)
    st.model = model
    st.serve = run.entry(prefill_logits)
    st.sizes = mixes.lengths(run.mix["lengths"])
    st.order = mixes.order(st.sizes, mixes.sub_seed(run.seed, "order"))
    st.data = torch.Generator(device=run.device).manual_seed(
        mixes.sub_seed(run.seed, "data"))
    warm = torch.Generator(device=run.device).manual_seed(
        mixes.sub_seed(run.seed, "warm-up"))
    for S in st.sizes:
        tok = mixes.token_ids(warm, (1, S), run.config["vocab_size"],
                              run.device)
        st.serve(st.model, {"tokens": tok}).argmax(-1)
    st.served = []                 # (tokens, greedy tokens) a request
    return st


def _request(run, st, S):
    tok = _prompt(run, st, S)
    t0 = time.perf_counter()
    out = st.serve(st.model, {"tokens": tok}).argmax(-1)
    run.sync()
    return tok, out, t0, time.perf_counter()


def window(run, st):
    """Requests until the window's seconds have passed and the cycle of
    lengths in progress is complete, so that every run's window holds
    whole cycles: the same work in another order."""
    t_start = time.perf_counter()
    while True:
        S = next(st.order)
        tok, out, t0, t1 = _request(run, st, S)
        st.served.append((tok, out))
        run.records.append(dict(t0=t0, t1=t1, seqs=[S]))
        if t1 - t_start >= run.seconds \
                and len(run.records) % len(st.sizes) == 0:
            break
    run.window_s = run.records[-1]["t1"] - t_start
    run.attempted = len(run.records)
    run.failed = 0


def trace(run, st):
    """The profiled stretch: the next ``trace_requests`` requests."""
    lengths = [next(st.order) for _ in range(run.mix["trace_requests"])]

    def one(i):
        _request(run, st, lengths[i])
    run.stretch = tracing.profile(run, one, len(lengths), None,
                                  seqs_of=lambda i: [lengths[i]])


def sample(run, n_done: int, lengths) -> list:
    """Indices of the checked requests: the first longest, then the mix's
    ``sample`` - 1 others drawn from the seed."""
    longest = max(range(n_done), key=lambda i: (lengths[i], -i))
    rest = [i for i in range(n_done) if i != longest]
    rng = random.Random(mixes.sub_seed(run.seed, "sample"))
    return [longest] + rng.sample(rest, min(len(rest), run.mix["sample"] - 1))


def token_gaps(ref_logits, tokens):
    """By position, how far the reference's logit of ``tokens`` (S,) lies
    below the reference's best."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, tokens[:, None].long())[:, 0]


def reference_views(run):
    """The seed's weights drawn again, in the configuration's dtype: the
    reference takes each layer's to float32 as it runs."""
    _, views = weights.make(run.layout, mixes.sub_seed(run.seed, "weights"),
                            run.device, run.port_config().torch_dtype)
    return views


def check(run, st):
    """Frees the model, then holds the sample's served tokens against the
    reference's logits."""
    lengths = [r["seqs"][0] for r in run.records]
    picked = sample(run, len(lengths), lengths)
    served = [st.served[i] for i in picked]
    st.model = st.flat = st.serve = st.served = None
    free_device()
    w = reference_views(run)
    gaps, control = [], []
    with fp32_products():
        for tok, out in served:
            lg = run.reference.logits(w, run.config, tok)[0]
            gaps.append(token_gaps(lg, out[0]))
            if run.control:
                # the control: the token that the reference's products in
                # float8 put first (portbench/readings.py, never a run)
                low = run.reference.logits(
                    w, run.config, tok, run.reference.Products("float8"))[0]
                control.append(token_gaps(lg, low.argmax(-1)))
                del low
            del lg
    numbers = summary(gaps)
    run.readings = dict(numbers, lengths=[lengths[i] for i in picked])
    if run.control:
        run.readings["control"] = summary(control)
    for name, limit in run.limits.items():
        run.checks.append((name, numbers[name], limit))


BANDS = (128, 512)      # positions a band of a request holds


def band_means(gaps, band: int) -> list:
    """Each request's positions in bands of ``band`` (the last shorter):
    the mean gap of every band."""
    return [float(x[i:i + band].mean()) for x in gaps
            for i in range(0, len(x), band)]


def summary(gaps) -> dict:
    """The served tokens' gaps over every position of the sample: the
    widest, the mean, the 99th percentile, the worst band's mean at each
    of BANDS, and the worst request's mean."""
    g = torch.cat(gaps)
    out = {"token_gap": float(g.max()), "token_gap_mean": float(g.mean()),
           "token_gap_p99": float(torch.quantile(g, 0.99)),
           "token_gap_request": max(float(x.mean()) for x in gaps)}
    for band in BANDS:
        out[f"token_gap_band{band}"] = max(band_means(gaps, band))
    return out
