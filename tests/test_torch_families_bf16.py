"""Every family in bfloat16 on the CPU, the port against the JAX package.

``reduced()`` is float32, so the float32 parity tests never meet the JAX
package's implicit promotions: bf16 times an fp32 array gives fp32 there,
while torch raises on a mixed ``einsum`` or ``@`` and rounds where a cast
goes the wrong way (the MoE router, the SSD decay terms, mamba2's fp32
block output and out_norm, the RG-LRU's fp32 decode state). Here both
packages run ``reduced(dtype="bfloat16")`` on the same bf16 weights:
parallel prefill, and sequential prefill of 4 tokens (4 decode steps).

The limit is the reference's own bf16 error: ``e_ref``, the relative RMS
of the JAX bf16 logits against the JAX package run in float32 on the same
(bf16-valued) weights and inputs. Two bf16 runs that round in other orders
(matmul sums, the RG-LRU scan's tree, which the port takes in fp32, K2's
fp32 scores) each sit about e_ref from the float32 result, so they may
differ by about sqrt(2) e_ref: the port must be within 2 e_ref of the JAX
bf16 logits, and no further than 1.25 e_ref from the float32 ones. e_ref
is 0.5-2.8% here (2-12 residual layers; bf16's unit roundoff is 2^-8).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.train import serve as jserve
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.train import serve as tserve

from test_torch_families_common import B, FAMILY_ARCHS, S, Pair, f32, rel_rms
from torch_parity import one_thread_module  # noqa: F401 (one thread)


@pytest.fixture(scope="module", params=sorted(set(FAMILY_ARCHS.values())))
def pair(request):
    p = Pair(request.param, dtype="bfloat16")
    p.jparams32 = jax.tree.map(lambda a: a.astype(jnp.float32), p.jparams)
    p.jcfg32 = jreg.load_config(request.param).reduced()
    return p


def _assert_within(got, want, ref32):
    e_ref = rel_rms(want, ref32)
    assert str(got.dtype) == "torch.bfloat16"
    assert rel_rms(got, want) <= 2 * e_ref
    assert rel_rms(got, ref32) <= 1.25 * e_ref


def test_bf16_prefill_within_limit(pair):
    want, got = pair.prefill()
    jb, _ = pair.batches()
    ref32 = jserve.prefill_logits(pair.jparams32, pair.jcfg32, jb)
    _assert_within(got, want, ref32)


def test_bf16_decode_steps_within_limit(pair):
    toks = pair.tokens[:, :4]
    (_, want), (_, got) = pair.sequential(tokens=toks, max_seq=8)
    frames = None if pair.frames is None else jnp.asarray(pair.frames)
    _, ref32 = jserve.sequential_prefill(
        pair.jparams32, pair.jcfg32, jnp.asarray(toks, jnp.int32), max_seq=8,
        frames=frames)
    assert got.shape == (B, 4, pair.tcfg.vocab)
    _assert_within(got, want, ref32)


def test_bf16_moe_with_global_layers_matches_jax(monkeypatch):
    """kimi-k2: MoE behind global attention, which the port sends to K2.

    K2 (like the Pallas kernel it replaces) keeps the scores in fp32; the
    JAX model's XLA attention rounds them to bf16 first. At this size that
    moves a router logit enough to flip a top-2 choice, and the capacity
    drop shifts with it (tokens 22 and 26 of the second prompt, relative
    RMS 0.068 against the JAX logits). So the comparison runs K2's dispatch
    with the XLA path's rounding, which is what is being held here: the
    MoE dispatch, its fp32 router and the promotions in bf16; the port's
    own path is held by the next test."""
    def xla_numerics(q, k, v, *, causal=True, window=0):
        pos = torch.arange(q.shape[1])
        mask = tlayers._mask(pos, pos, causal, window)[None, None]
        return tlayers.gqa_attend(q, k, v, mask).reshape(q.shape)

    monkeypatch.setattr(ops, "flash_attention", xla_numerics)
    p = Pair("kimi-k2-1t-a32b", dtype="bfloat16")
    want, got = p.prefill()
    jb, _ = p.batches()
    ref32 = jserve.prefill_logits(
        jax.tree.map(lambda a: a.astype(jnp.float32), p.jparams),
        jreg.load_config("kimi-k2-1t-a32b").reduced(), jb)
    _assert_within(got, want, ref32)
    assert np.isfinite(want).all()


def _dispatch(top_idx, n_experts):
    """Per token, the set of (expert, kept) pairs of the reference's sort-
    based dispatch (JAX moe.py:66-76) from its top-k experts (T, K)."""
    T, K = top_idx.shape
    flat_e = top_idx.reshape(T * K)
    order = np.argsort(flat_e, kind="stable")
    se, st = flat_e[order], np.repeat(np.arange(T), K)[order]
    counts = np.bincount(flat_e, minlength=n_experts)
    pos_in_e = np.arange(T * K) - (np.cumsum(counts) - counts)[se]
    C = tmoe.capacity(SimpleNamespace(top_k=K, n_experts=n_experts), T)
    out = [set() for _ in range(T)]
    for e, t, keep in zip(se, st, pos_in_e < C):
        out[t].add((int(e), bool(keep)))
    return out


def test_bf16_moe_real_path_differs_only_downstream_of_a_flip(monkeypatch):
    """kimi-k2 in bf16 with the port's own attention (K2's plain version,
    fp32 scores), unpatched: its logits may leave the JAX package's only
    where the MoE dispatch differs. Both runs' top-k choices are recorded
    at every MoE layer; a token whose (expert, kept) set differs in any
    layer, and every later token of its prompt (causal attention carries
    the change forward), is downstream of a flip. Every other token must
    be within the limits of ``_assert_within``, and the flips few."""
    E = jreg.load_config("kimi-k2-1t-a32b").reduced().n_experts
    j_top, t_top = [], []
    real_top_k, real_route = jax.lax.top_k, tmoe.route

    def top_k(x, k):
        out = real_top_k(x, k)
        if x.shape[-1] == E:
            jax.debug.callback(lambda i: j_top.append(np.asarray(i)), out[1])
        return out

    def route(router, cfg, xt):
        r = real_route(router, cfg, xt)
        top = np.zeros((xt.shape[0], cfg.top_k), np.int64)
        st, se = r["st"].numpy(), r["se"].numpy()
        for t in range(xt.shape[0]):
            top[t] = np.sort(se[st == t])
        t_top.append(top)
        return r

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    monkeypatch.setattr(tmoe, "route", route)
    p = Pair("kimi-k2-1t-a32b", dtype="bfloat16")
    want, got = p.prefill()
    jax.block_until_ready(want)
    jb, _ = p.batches()
    ref32 = np.asarray(jserve.prefill_logits(
        jax.tree.map(lambda a: a.astype(jnp.float32), p.jparams),
        jreg.load_config("kimi-k2-1t-a32b").reduced(), jb))
    n_moe = p.tcfg.n_layers
    j_top = j_top[:n_moe]
    assert len(j_top) == len(t_top) == n_moe
    T = B * S
    flipped = np.zeros(T, bool)
    for jt, tt in zip(j_top, t_top):
        flipped |= np.array([a != b for a, b in zip(_dispatch(jt, E),
                                                    _dispatch(tt, E))])
    # downstream: at or after the first flipped token of the same prompt
    flipped = flipped.reshape(B, S)
    down = np.cumsum(flipped, axis=1) > 0
    assert flipped.sum() <= 2 * B
    keep = ~down.reshape(T)
    assert keep.sum() >= 3 * T // 4
    g, w, r = (f32(a).reshape(T, -1)[keep] for a in (got, want, ref32))
    e_ref = rel_rms(w, r)
    assert rel_rms(g, w) <= 2 * e_ref
    assert rel_rms(g, r) <= 1.25 * e_ref


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_bf16_sequential_prefill_gap_is_the_references(family):
    """mamba2's and recurrentgemma's bf16 decode rounds where their prefill
    does not, in the JAX package itself: mamba2 reads its fp32 state out
    in bf16 and forms its update in bf16, where prefill's SSD stays fp32;
    recurrentgemma keeps an fp32 decode state beside a bf16 scan. So the
    sequential and parallel logits of one model differ in both packages
    (the JAX package's gap at 12 layers: 0.075 and 0.039 relative RMS; its
    dense families' is ~0 on the CPU), by a gap that grows with depth.
    The port's gap must be the reference's, within 1.5x of it. On the
    card, chip_smoke.py holds these two families' paths in float32."""
    p = Pair(FAMILY_ARCHS[family], dtype="bfloat16", n_layers=12)
    jb, tb = p.batches()
    jpar = jserve.prefill_logits(p.jparams, p.jcfg, jb)
    tpar = tserve.prefill_logits(p.model, tb)
    (_, jseq), (_, tseq) = p.sequential(max_seq=S)
    ref_gap, gap = rel_rms(jseq, jpar), rel_rms(tseq, tpar)
    assert ref_gap > 2e-2
    assert gap <= 1.5 * ref_gap
