"""Every model family of the port against the JAX package, float32 on the
CPU, on one reduced config per family (gemma3-12b for dense, mixtral for
moe, mamba2, recurrentgemma, qwen2-vl, whisper).

Prefill is held against prefill, sequential prefill against sequential
prefill and decode against decode, never across: the MoE capacity drop
makes them differ in the reference itself (mixtral drops rows in a
64-token prefill and none in a 2-token decode step). vlm prefill carries
patch embeddings and audio the encoder's frames; each family also runs
once with explicit positions, which take RoPE from them and the plain
attention path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.train import serve as jserve
from repro_torch.models import registry as treg
from repro_torch.train import serve as tserve

from test_torch_families_common import B, FAMILY_ARCHS, N_DECODE, S, TOL, Pair, f32
from torch_parity import one_thread_module  # noqa: F401 (one thread)


@pytest.fixture(scope="module", params=list(FAMILY_ARCHS.values()))
def pair(request):
    return Pair(request.param)


def test_prefill_matches_jax(pair):
    want, got = pair.prefill()
    n_vis = pair.tcfg.vision_tokens
    assert got.shape == (B, S + n_vis, pair.tcfg.vocab)
    np.testing.assert_allclose(f32(got), want, atol=TOL, rtol=TOL)


def test_sequential_prefill_matches_jax(pair):
    (_, want), (_, got) = pair.sequential()
    assert got.shape == (B, S, pair.tcfg.vocab)
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL, rtol=TOL)


def test_decode_tokens_match_jax(pair):
    (jcache, jlogits), (tcache, _) = pair.sequential()
    last = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
    _, want = jserve.decode_tokens(pair.jparams, pair.jcfg, jcache, last, S,
                                   N_DECODE)
    _, got = tserve.decode_tokens(pair.model, tcache,
                                  torch.from_numpy(np.array(last)).long(),
                                  S, N_DECODE)
    assert got.shape == (B, N_DECODE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_explicit_positions_match_jax(pair):
    """Positions 5, 7, 9, ...: RoPE (M-RoPE for qwen2-vl, over patches and
    text) rotates by them and the causal and window masks read them, so
    they differ from 0..S-1 wherever a family uses positions (mamba2 has
    none; whisper's only mask is its causal one)."""
    n = S + pair.tcfg.vision_tokens
    positions = (5 + 2 * np.arange(n)).astype(np.int32)
    want, got = pair.prefill(positions=positions)
    np.testing.assert_allclose(f32(got), want, atol=TOL, rtol=TOL)


def test_vlm_prefill_without_patches_matches_jax():
    """qwen2-vl on text alone: M-RoPE with equal (t, h, w) positions."""
    p = Pair(FAMILY_ARCHS["vlm"])
    want, got = p.prefill(patches=False)
    assert got.shape == (B, S, p.tcfg.vocab)
    np.testing.assert_allclose(f32(got), want, atol=TOL, rtol=TOL)


def test_sequential_prefill_matches_parallel_in_the_port(pair):
    """The port's twin of tests/test_serve_numeric.py. For moe the two
    paths differ in the reference too (capacity drop in the 64-token
    prefill): there the port's difference must be the reference's."""
    jb, tb = pair.batches(patches=False)
    par = f32(tserve.prefill_logits(pair.model, tb))
    (_, jseq), (_, seq) = pair.sequential(max_seq=S)
    if pair.family == "moe":
        jpar = np.asarray(jserve.prefill_logits(pair.jparams, pair.jcfg, jb))
        assert np.abs(jpar - f32(jseq)).max() > 1e-2   # drops do show
        np.testing.assert_allclose(par - f32(seq), jpar - f32(jseq),
                                   atol=2 * TOL, rtol=TOL)
    else:
        np.testing.assert_allclose(f32(seq), par, atol=TOL, rtol=TOL)


def test_collect_kv_and_return_hidden_match_jax():
    """dense forward's collect_kv (per layer here, per pattern position and
    repetition in JAX) and return_hidden (the final normed hidden state)."""
    p = Pair("gemma3-12b")
    from repro.models import dense as jdense
    from repro_torch.models import dense as tdense
    jb, tb = p.batches()
    jh, jkv = jdense.forward(p.jparams, p.jcfg, jb["tokens"],
                             collect_kv=True, return_hidden=True)
    th, tkv = tdense.forward(p.model, tb["tokens"], collect_kv=True,
                             return_hidden=True)
    np.testing.assert_allclose(f32(th), f32(jh), atol=TOL, rtol=TOL)
    P = len(p.tcfg.pattern)
    assert len(tkv) == p.tcfg.n_layers
    for layer, (k, v) in enumerate(tkv):
        g, i = divmod(layer, P)
        jk, jv = jkv["scan"][i]
        np.testing.assert_allclose(f32(k), f32(jk[g]), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(f32(v), f32(jv[g]), atol=TOL, rtol=TOL)
    # registry.forward(return_hidden=True) and moe's aux loss as extras
    m = Pair("mixtral-8x7b")
    jb, tb = m.batches()
    jh, jx = jreg.forward(m.jparams, m.jcfg, jb, return_hidden=True)
    th, tx = treg.forward(m.model, tb, return_hidden=True)
    np.testing.assert_allclose(f32(th), f32(jh), atol=TOL, rtol=TOL)
    assert tx["aux_loss"].dtype == torch.float32
    np.testing.assert_allclose(tx["aux_loss"].item(),
                               float(jx["aux_loss"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "command-r-35b",
                                  "gemma3-27b"])
def test_other_configs_prefill_and_decode_match_jax(arch):
    """The configs beyond one per family: kimi-k2 (moe, global layers, 4 of
    384 experts reduced), command-r and gemma3-27b (dense)."""
    p = Pair(arch)
    want, got = p.prefill()
    np.testing.assert_allclose(f32(got), want, atol=TOL, rtol=TOL)
    (_, want), (_, got) = p.sequential()
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL, rtol=TOL)


def test_hybrid_tail_layers_keep_their_roles():
    """recurrentgemma at 5 layers: pattern (rec, rec, local) once plus a
    tail of (rec, rec), converted from JAX's blocks/p{i} and tail/p{i}."""
    p = Pair("recurrentgemma-2b", n_layers=5)
    roles = [("rglru" in dict(b.named_children())) for b in p.model.blocks]
    assert roles == [True, True, False, True, True]
    np.testing.assert_array_equal(
        p.model.blocks[3].rglru.in_x.numpy(),
        np.asarray(p.jparams["tail"]["p0"]["rglru"]["in_x"]))
    want, got = p.prefill()
    np.testing.assert_allclose(f32(got), want, atol=TOL, rtol=TOL)
    (_, want), (_, got) = p.sequential()
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL, rtol=TOL)
