"""Distribution-strategy case suite in torch (paper §6 workloads + §6.2 bug
study, plus the FSDP/ZeRO, pipeline-parallel, and 2D-mesh families from the
bug-study literature in PAPERS.md).

The JAX package's cases rewritten on the SPMD shim
(``repro_torch.core.spmd``), with the same names, degrees, bugs and
expectations, sizes, input names and specs. Each builder is registered
with ``@register_strategy`` and returns a typed
:class:`repro_torch.api.StrategySpec` carrying:

  seq_fn       the sequential model fragment G_s (a plain torch function)
  dist_fn      the per-rank SPMD implementation, traced by ``capture_spmd``
               (the shim's collectives allowed)
  mesh_axes    {axis name: parallelism degree}
  in_specs     ``PartitionSpec`` per input — ``derive_input_relation`` turns
               these into R_i
  avals        ``TensorSpec`` (shape, dtype) per (global) input
  input_names  logical input names

plus registry-stamped metadata (case name, degree, bug, expected verdict).
Each builder takes ``device`` and makes its constants there (``cuda``
unless ``"cpu"`` is asked for).

``bug=<name>`` injects one of the ten real-world bug classes (paper §6.2
plus the FSDP/pipeline/2D-mesh studies) into the distributed side.  Each bug is declared on its host case as a
``BugSpec`` whose ``expected`` states how detection surfaces:
``refinement_error`` (localized raise) or ``unexpected_relation`` (paper
bug 5 — a clean but unexpected certificate the user inspects).  The two
documented completeness gaps are ``expected="incomplete"`` on the clean
case itself (sound false alarm — see EXPERIMENTS.md §Gaps).

Sizes are deliberately small: verification cost is driven by operator count
and parallelism degree, not tensor extents (the engine is symbolic).

``STRATEGY_CASES`` / ``BUG_CASES`` are read-only views; the registry
(``repro_torch.api.list_strategies``/``list_bugs``) is the source of truth.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..api.registry import register_strategy
from ..api.spec import BugSpec, StrategySpec, TensorSpec, axis_degrees
from ..core import spmd
from ..core.spmd import P
from ..models.registry import resolve_device


def _aval(shape):
    return TensorSpec(tuple(shape), torch.float32)


# ---------------------------------------------------------------------------
# tp_layer — Megatron-style tensor-parallel MLP block
# ---------------------------------------------------------------------------

@register_strategy("tp_layer", degrees=(2, 4, 8),
                   description="Megatron TP MLP (col/row-parallel W1/W2)")
def tp_transformer_layer(degree: int = 2, bug=None, seq: int = 4,
                         d_model: int = 8, d_ff: int = 8, device=None):
    """Column-parallel W1, row-parallel W2, psum to assemble the output.
    The canonical TP pattern (paper Fig. 2): the k-split matmul pairs with
    the psum expansion to an add over the rank group."""
    assert d_ff % degree == 0

    def seq_fn(x, w1, w2):
        return torch.tanh(x @ w1) @ w2

    def dist_fn(x, w1, w2):
        h = torch.tanh(x @ w1)        # x replicated, w1 column shard
        yp = h @ w2                   # w2 row shard -> partial sums
        return spmd.psum(yp, "tp")

    return StrategySpec(
        seq_fn, dist_fn, {"tp": degree},
        (P(), P(None, "tp"), P("tp", None)),
        (_aval((seq, d_model)), _aval((d_model, d_ff)),
         _aval((d_ff, d_model))),
        ("x", "w1", "w2"))


# ---------------------------------------------------------------------------
# sp_rope — sequence-parallel rotary position embedding
# ---------------------------------------------------------------------------

@register_strategy(
    "sp_rope", degrees=(2, 4, 8),
    bugs=[BugSpec("rope_offset", "refinement_error",
                  "every rank slices cos/sin at local positions (offset 0) "
                  "— the vLLM/Neuron bug class")],
    description="sequence-parallel rotary embedding (offset slices)")
def sp_rope_layer(degree: int = 2, bug=None, seq: int = 8, d_model: int = 8,
                  device=None):
    """Rotary embedding under a sequence shard: each rank must slice the
    cos/sin tables at its *global* position offset (rank * chunk).
    Bug `rope_offset`: every rank uses local positions (offset 0) — the
    real-world vLLM/Neuron bug class from the paper's case study."""
    assert seq % degree == 0 and d_model % 2 == 0
    half = d_model // 2
    pos = np.arange(seq, dtype=np.float32)[:, None]
    inv = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) / half))
    # the tables are computed in numpy float32, as the JAX case computes
    # them, and made on the device
    dev = resolve_device(device)
    cos = torch.from_numpy(np.cos(pos * inv).astype(np.float32)).to(dev)
    sin = torch.from_numpy(np.sin(pos * inv).astype(np.float32)).to(dev)
    chunk = seq // degree

    def seq_fn(x):
        x1, x2 = x[:, :half], x[:, half:]
        y1 = x1 * cos - x2 * sin
        y2 = x2 * cos + x1 * sin
        return torch.cat([y1, y2], dim=1)

    def dist_fn(x):
        if bug == "rope_offset":
            start = 0                 # BUG: local positions on every rank
        else:
            start = spmd.axis_index("sp") * chunk
        c = spmd.dynamic_slice(cos, (start, 0), (chunk, half))
        s = spmd.dynamic_slice(sin, (start, 0), (chunk, half))
        x1, x2 = x[:, :half], x[:, half:]
        y1 = x1 * c - x2 * s
        y2 = x2 * c + x1 * s
        return torch.cat([y1, y2], dim=1)

    return StrategySpec(seq_fn, dist_fn, {"sp": degree}, (P("sp", None),),
                        (_aval((seq, d_model)),), ("x",))


# ---------------------------------------------------------------------------
# sp_pad — pad-to-block then slice-off under a sequence shard
# ---------------------------------------------------------------------------

@register_strategy(
    "sp_pad", degrees=(2, 4, 8),
    bugs=[BugSpec("pad_slice", "refinement_error",
                  "the slice keeps padding rows and drops real tokens — "
                  "the pad/slice mismatch class")],
    description="pad-to-block + slice-off per rank")
def sp_pad_slice(degree: int = 2, bug=None, seq: int = 8, d_model: int = 4,
                 pad: int = 2, device=None):
    """Each rank pads its shard to a kernel block size, computes, then
    slices the padding back off. Bug `pad_slice`: the slice keeps the wrong
    rows (drops real tokens, keeps padding) — the paper's pad/slice
    mismatch class."""
    assert seq % degree == 0
    chunk = seq // degree

    def seq_fn(x):
        return torch.tanh(x)

    def dist_fn(x):
        p = F.pad(x, (0, 0, 0, pad))
        h = torch.tanh(p)
        if bug == "pad_slice":
            return h[pad:pad + chunk]     # BUG: off-by-pad slice
        return h[:chunk]

    return StrategySpec(seq_fn, dist_fn, {"sp": degree}, (P("sp", None),),
                        (_aval((seq, d_model)),), ("x",))


# ---------------------------------------------------------------------------
# ep_moe — expert-parallel MoE with pre-routed tokens
# ---------------------------------------------------------------------------

@register_strategy(
    "ep_moe", degrees=(2, 4, 8),
    bugs=[BugSpec("sharded_expert", "refinement_error",
                  "expert-to-shard mapping rotated via ppermute — each rank "
                  "applies its neighbour's expert weights")],
    description="expert-parallel MoE, pre-routed tokens")
def ep_moe_layer(degree: int = 2, bug=None, tokens: int = 4, d_model: int = 4,
                 device=None):
    """Expert e lives on rank e; tokens arrive pre-sorted by expert, so the
    token shard on rank e is exactly expert e's batch. Bug `sharded_expert`:
    the expert-to-shard mapping is rotated (each rank applies its
    neighbour's expert weights via ppermute) — the paper's mis-sharded
    expert weight class."""
    n_exp = degree

    def seq_fn(x, w):
        outs = []
        for e in range(n_exp):
            xe = x[e * tokens:(e + 1) * tokens]
            outs.append(xe @ w[e])
        return torch.cat(outs, dim=0)

    def dist_fn(x, w):
        we = w[0]                     # local expert shard (1, D, D) -> (D, D)
        if bug == "sharded_expert":
            we = spmd.ppermute(
                we, "ep", [(i, (i + 1) % n_exp) for i in range(n_exp)])
        return x @ we

    return StrategySpec(
        seq_fn, dist_fn, {"ep": degree},
        (P("ep", None), P("ep", None, None)),
        (_aval((n_exp * tokens, d_model)), _aval((n_exp, d_model, d_model))),
        ("x", "w"))


# ---------------------------------------------------------------------------
# aux_loss — auxiliary-loss normalization (documented completeness gap)
# ---------------------------------------------------------------------------

@register_strategy(
    # the n-ary add normal form collapsed degree 8 from ~8 s to
    # milliseconds, so the full sweep is registered
    "aux_loss", degrees=(2, 4, 8),
    bugs=[BugSpec("aux_scale", "refinement_error",
                  "each rank averages by its local element count before the "
                  "psum, inflating the loss by the parallelism degree")],
    description="aux-loss normalization (reduce-of-reshape + scalar factor)")
def aux_loss_scale(degree: int = 2, bug=None, seq: int = 8, d_model: int = 4,
                   device=None):
    """Load-balancing-style scalar loss. The sequential side sums a
    *flattened* view while the distributed side reduces both axes at once —
    the ``reduce_reshape`` segment lemma relates the reduction across the
    reshape boundary and the constrained ``scalar_factor`` lemma lets the
    global ``/ n`` normalization chase per-rank pieces, so the correct
    implementation now certifies (this was a documented completeness gap
    until those two lemmas landed).
    Bug `aux_scale`: each rank averages by its *local* element count before
    the psum, inflating the loss by the parallelism degree — the paper's
    aux-loss mis-scaling class."""
    assert seq % degree == 0
    n = seq * d_model
    local_n = (seq // degree) * d_model

    def seq_fn(p):
        return torch.sum(p.reshape(-1)) / n

    def dist_fn(p):
        loc = torch.sum(p)
        if bug == "aux_scale":
            return spmd.psum(loc / local_n, "ep")      # BUG: degree x too big
        return spmd.psum(loc, "ep") / n

    return StrategySpec(seq_fn, dist_fn, {"ep": degree}, (P("ep", None),),
                        (_aval((seq, d_model)),), ("p",))


# ---------------------------------------------------------------------------
# sp_moe — sequence-parallel gated FFN stack (the fig5 scaling case)
# ---------------------------------------------------------------------------

@register_strategy("sp_moe", degrees=(2, 4, 8),
                   description="4x chained gated FFN, sequence-parallel")
def sp_moe_layer(degree: int = 2, bug=None, seq: int = 16, d_model: int = 8,
                 d_ff: int = 8, device=None):
    """Four chained gated-FFN blocks under a sequence shard with replicated
    weights. Pure row parallelism — no collectives — but every operator's
    relation is a degree-wide concat, so e-graph size and lemma work scale
    with the degree (paper Fig. 5's scaling axis), and the chained blocks
    give the relation chains realistic depth."""
    assert seq % degree == 0

    def block(x, wg, w1, w2):
        h = torch.tanh(x @ w1)
        g = torch.sigmoid(x @ wg)
        return (h * g) @ w2

    def seq_fn(x, wg, w1, w2):
        u = x
        for _ in range(4):
            u = block(u, wg, w1, w2)
        return u

    dist_fn = seq_fn                  # same per-rank program, sharded inputs

    return StrategySpec(
        seq_fn, dist_fn, {"sp": degree},
        (P("sp", None), P(), P(), P()),
        (_aval((seq, d_model)), _aval((d_model, d_ff)),
         _aval((d_model, d_ff)), _aval((d_ff, d_model))),
        ("x", "wg", "w1", "w2"))


# ---------------------------------------------------------------------------
# grad_accum — microbatch gradient accumulation (gap closed by dus_concat)
# ---------------------------------------------------------------------------

@register_strategy(
    "grad_accum", degrees=(2, 4),
    bugs=[BugSpec("grad_accum", "refinement_error",
                  "final normalization divides by the per-rank element "
                  "count — accumulated gradients n_steps x too large")],
    description="microbatch grad accumulation (dus scatter buffer)")
def grad_accum_step(degree: int = 2, bug=None, batch: int = 8,
                    d_model: int = 4, device=None):
    """Data-parallel gradient step with per-rank microbatch accumulation
    into a scatter buffer (dynamic_update_slice), then a psum and a global
    normalization. The buffer-scatter accumulation certifies via the
    constrained ``dus_concat`` lemma (a complete dus chain over a zero-init
    buffer is the concat of its updates) — this was a documented
    completeness gap until that lemma landed.
    Bug `grad_accum`: the final normalization divides by the per-rank
    element count instead of the global batch — the HF-regression class
    where accumulated gradients come out n_steps x too large."""
    assert batch % (2 * degree) == 0
    local = batch // degree
    half = local // 2

    def seq_fn(x):
        return torch.sum(x, dim=0) / batch

    def dist_fn(x):
        g1 = torch.sum(x[:half], dim=0)
        g2 = torch.sum(x[half:], dim=0)
        buf = torch.zeros((2, x.shape[1]), dtype=x.dtype, device=x.device)
        buf = spmd.dynamic_update_slice(buf, g1[None], (0, 0))
        buf = spmd.dynamic_update_slice(buf, g2[None], (1, 0))
        acc = torch.sum(buf, dim=0)
        tot = spmd.psum(acc, "dp")
        denom = local if bug == "grad_accum" else batch   # BUG: missing 1/deg
        return tot / denom

    return StrategySpec(seq_fn, dist_fn, {"dp": degree}, (P("dp", None),),
                        (_aval((batch, d_model)),), ("x",))


# ---------------------------------------------------------------------------
# ln_grad — layer-norm weight gradient under sequence parallelism
# ---------------------------------------------------------------------------

@register_strategy(
    "ln_grad", degrees=(2, 4, 8),
    bugs=[BugSpec("ln_no_allreduce", "unexpected_relation",
                  "the psum is skipped — no raise, but the certificate is a "
                  "cross-rank add instead of an identity map (paper bug 5)")],
    description="layer-norm weight grad over sharded seq")
def ln_weight_grad(degree: int = 2, bug=None, seq: int = 8, d_model: int = 4,
                   device=None):
    """The weight-gradient reduction of a norm layer: sum over the (sharded)
    sequence axis needs a cross-rank all-reduce. Bug `ln_no_allreduce`
    (paper bug 5): the psum is skipped. No error is raised — the inferred
    R_o is clean but *unexpected* (a cross-rank add instead of an identity
    map), which is how the paper reports the user caught it."""
    assert seq % degree == 0

    def seq_fn(dy, xhat):
        return torch.sum(dy * xhat, dim=0)

    def dist_fn(dy, xhat):
        loc = torch.sum(dy * xhat, dim=0)
        if bug == "ln_no_allreduce":
            return loc                # BUG: per-rank partial, no all-reduce
        return spmd.psum(loc, "sp")

    return StrategySpec(
        seq_fn, dist_fn, {"sp": degree}, (P("sp", None), P("sp", None)),
        (_aval((seq, d_model)), _aval((seq, d_model))),
        ("dy", "xhat"))


# ---------------------------------------------------------------------------
# fsdp_mlp — ZeRO-3-style fully-sharded MLP (weight gather + grad scatter)
# ---------------------------------------------------------------------------

@register_strategy(
    # degree 8 certifies in ~3 s (was ~21 s before the n-ary add normal
    # form) — reachable via --degrees 8, kept off the default sweep so the
    # matrix stays sub-second
    "fsdp_mlp", degrees=(2, 4),
    bugs=[BugSpec("stale_shard", "refinement_error",
                  "the forward uses the local W1 shard tiled degree times "
                  "instead of the all_gather — the stale/ungathered "
                  "parameter class of ZeRO-3 implementations"),
          BugSpec("rs_wrong_axis", "unexpected_relation",
                  "the gradient reduce_scatter splits the wrong dimension — "
                  "no raise, but R_o assembles grad shards along dim 1 "
                  "instead of dim 0 (paper bug 5 detection mode)")],
    description="ZeRO-3 FSDP MLP: all_gather weights, reduce_scatter grads")
def fsdp_mlp_layer(degree: int = 2, bug=None, batch: int = 8,
                   d_model: int = 8, d_ff: int = 8, device=None):
    """ZeRO-3-style fully-sharded MLP step: every parameter lives sharded on
    dim 0 across the data-parallel group; the forward all_gathers W1/W2
    before compute, and the (pseudo-)weight gradient of W2 is
    reduce_scattered back so each rank keeps exactly its shard's gradient.
    Outputs: the batch-sharded activation and the rank-local grad shard.
    Bug `stale_shard`: the forward skips the W1 gather and tiles the local
    shard — the stale/ungathered parameter class. Bug `rs_wrong_axis`: the
    reduce_scatter splits dim 1 instead of dim 0 — clean certificate, but
    R_o concatenates grad shards along the wrong axis (paper bug 5)."""
    assert batch % degree == 0 and d_model % degree == 0 \
        and d_ff % degree == 0

    def seq_fn(x, w1, w2):
        h = torch.tanh(x @ w1)
        y = h @ w2
        gw2 = h.T @ y                 # pseudo-gradient of w2
        return y, gw2

    def dist_fn(x, w1s, w2s):
        if bug == "stale_shard":
            w1 = torch.cat([w1s] * degree, dim=0)          # BUG: no gather
        else:
            w1 = spmd.all_gather(w1s, "dp", axis=0, tiled=True)
        w2 = spmd.all_gather(w2s, "dp", axis=0, tiled=True)
        h = torch.tanh(x @ w1)
        y = h @ w2
        gw2_partial = h.T @ y
        sd = 1 if bug == "rs_wrong_axis" else 0            # BUG: wrong dim
        gw2s = spmd.psum_scatter(gw2_partial, "dp", scatter_dimension=sd,
                                 tiled=True)
        return y, gw2s

    return StrategySpec(
        seq_fn, dist_fn, {"dp": degree},
        (P("dp", None), P("dp", None), P("dp", None)),
        (_aval((batch, d_model)), _aval((d_model, d_ff)),
         _aval((d_ff, d_model))),
        ("x", "w1", "w2"))


# ---------------------------------------------------------------------------
# pp_stage — pipeline-parallel stage chain with microbatch hand-offs
# ---------------------------------------------------------------------------

@register_strategy(
    "pp_stage", degrees=(2, 4),
    bugs=[BugSpec("drop_microbatch", "refinement_error",
                  "the hand-off loop feeds microbatch 0 into the last "
                  "microbatch's slot — one microbatch of work is silently "
                  "dropped from the schedule")],
    description="pipeline-parallel stage chain, microbatch ppermute relay")
def pp_stage_block(degree: int = 2, bug=None, batch: int = 4,
                   d_model: int = 4, n_micro: int = 2, device=None):
    """GPipe-style pipeline: stage s's weight lives on rank s (the stacked
    weight tensor is sharded on its leading stage axis), the input is
    replicated, and each microbatch's activation is relayed rank-to-rank
    with ``ppermute`` after every stage — so the last rank's accumulated
    microbatch outputs are exactly the sequential chain, and R_o is the
    single-rank projection ``y = out@pp{n-1}``. Bug `drop_microbatch`: the
    relay loop reads microbatch 0 again in the last slot, dropping the
    final microbatch — the paper bug studies' lost-microbatch schedule
    class."""
    assert batch % n_micro == 0
    mb = batch // n_micro
    n_stage = degree

    def seq_fn(x, w):
        h = x
        for s in range(n_stage):
            h = torch.tanh(h @ w[s])
        return h

    def dist_fn(x, w):
        wloc = w[0]                   # this rank's stage weight (stage shard)
        outs = []
        for m in range(n_micro):
            src = 0 if (bug == "drop_microbatch" and m == n_micro - 1) \
                else m                # BUG: last slot re-reads microbatch 0
            h = spmd.dynamic_slice(x, (src * mb, 0), (mb, d_model))
            for s in range(n_stage):
                h = torch.tanh(h @ wloc)
                if s < n_stage - 1:   # relay activation to the next stage
                    h = spmd.ppermute(
                        h, "pp", [(i, i + 1) for i in range(n_stage - 1)])
            outs.append(h)
        return torch.cat(outs, dim=0)

    return StrategySpec(
        seq_fn, dist_fn, {"pp": degree},
        (P(), P("pp", None, None)),
        (_aval((batch, d_model)), _aval((n_stage, d_model, d_model))),
        ("x", "w"))


# ---------------------------------------------------------------------------
# tp_dp_2d — composed 2D mesh: Megatron TP x data parallelism
# ---------------------------------------------------------------------------

@register_strategy(
    # (4, 4) — a 16-rank mesh whose multi-axis psum is a 16-wide add
    # chain — certifies in milliseconds under the n-ary add normal form
    # (it used to blow up assoc/comm saturation and false-alarm)
    "tp_dp_2d", degrees=((2, 2), (2, 4), (4, 2), (4, 4)),
    bugs=[BugSpec("psum_wrong_axis", "refinement_error",
                  "the output all-reduce runs over the dp mesh axis instead "
                  "of tp — partial sums are combined across batch shards")],
    description="2D mesh (dp x tp) Megatron MLP, multi-axis psum")
def tp_dp_2d_mlp(degree=(2, 2), bug=None, seq: int = 4, d_model: int = 8,
                 d_ff: int = 8, device=None):
    """The Megatron MLP composed with data parallelism on a 2D mesh
    ``{"dp": d_dp, "tp": d_tp}``: the batch is sharded over dp, W1/W2 are
    col/row-sharded over tp and replicated over dp. Every input relation is
    multi-mapping (one concat per replica coordinate on the unused axis),
    the scalar loss is a *multi-axis* ``psum`` over ``("dp", "tp")``, and
    the row-parallel output needs the tp-group psum — exercising
    ``concat_inject`` (shard-replica equality) and ``reduce_add``
    (reduce/psum exchange). ``degree`` may be an int (both axes) or a
    per-axis ``(d_dp, d_tp)`` tuple. Bug `psum_wrong_axis`: the output
    all-reduce runs over dp instead of tp, combining partial sums across
    batch shards — the composed-mesh wrong-axis collective class."""
    d_dp, d_tp = axis_degrees(degree, 2)
    assert seq % d_dp == 0 and d_ff % d_tp == 0

    def seq_fn(x, w1, w2):
        y = torch.tanh(x @ w1) @ w2
        return y, torch.sum(y)

    def dist_fn(x, w1, w2):
        h = torch.tanh(x @ w1)        # x: dp batch shard, w1: tp col shard
        yp = h @ w2                   # w2: tp row shard -> partial sums
        axis = "dp" if bug == "psum_wrong_axis" else "tp"   # BUG: wrong axis
        y = spmd.psum(yp, axis)
        tot = spmd.psum(torch.sum(yp), ("dp", "tp"))        # multi-axis psum
        return y, tot

    return StrategySpec(
        seq_fn, dist_fn, {"dp": d_dp, "tp": d_tp},
        (P("dp", None), P(None, "tp"), P("tp", None)),
        (_aval((seq, d_model)), _aval((d_model, d_ff)),
         _aval((d_ff, d_model))),
        ("x", "w1", "w2"))


# ---------------------------------------------------------------------------
# read-only views (source of truth: the repro_torch.api registry)
# ---------------------------------------------------------------------------

from ..api.registry import get_strategy as _get, list_bugs as _list_bugs, \
    list_strategies as _list_strategies  # noqa: E402 — after registration

STRATEGY_CASES = {name: _get(name).builder for name in _list_strategies()}

# bug name -> (host case builder, detection raises RefinementError?)
# False = paper bug 5 style: certificate is produced but its relation is not
# the one the user expects (inspected, not raised).
BUG_CASES = {bug: (_get(host).builder, bspec.raises)
             for bug, (host, bspec) in _list_bugs().items()}
