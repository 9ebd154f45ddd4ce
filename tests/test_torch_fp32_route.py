"""K2's float32 route as the card runs it, emulated on the CPU: 3xTF32
products, the tiles of ``fp32_plan``, delta recomputed a block, and the
backward's GQA partials summed in split order.

The kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)
run only on the card. Their arithmetic is kept testable here: each fp32
operand is split as two TF32 values (``tf32_split``: hi rounded as
``cvt.rna.tf32.f32`` rounds, to nearest with ties away from zero, and lo =
x - hi as the tensor core reads it, its low 13 bits dropped; 10 explicit
mantissa bits each) and every product is a_lo b_hi + a_hi b_lo + a_hi b_hi
summed in fp32, tile by tile over the plan's tiles. On inputs made from a numpy seed, the emulated
forward, LSE and gradients are held against the JAX package's attention
reference and ``jax.vjp`` of it (the JAX layers' masked attention where
there is a window) and against the closed form, within 2e-5: ten times
under the 2e-4 the card's checks hold the kernels to. The plan is checked
as a pure function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trn
from torch_parity import one_thread_module  # noqa: F401 (one thread)

TOL = 2e-5


# --- 3xTF32 ----------------------------------------------------------------

def tf32_round(x):
    """``cvt.rna.tf32.f32``: x (fp32) rounded to 10 explicit mantissa bits,
    to nearest with ties away from zero (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x):
    """x (fp32) as a TF32 operand reads it: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    """x as the kernels' operands hi + lo, both TF32: hi = rna(x), and lo =
    x - hi (exact in fp32) as the tensor core reads it, truncated."""
    hi = tf32_round(x)
    return hi, tf32_truncate(x - hi)


def mm3(a, b):
    """a @ b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms
    first, each product of TF32 values exact in fp32."""
    ahi, alo = tf32_split(a)
    bhi, blo = tf32_split(b)
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


@pytest.mark.parametrize("seed", range(4))
def test_tf32_split_reconstructs_within_2_pow_minus_21(seed):
    """hi + lo reconstructs x within 2^-21 |x| (hi's rounding leaves at most
    2^-11 |x|, of which truncating lo to TF32 loses at most 2^-10), and hi
    and lo each keep at most 10 explicit mantissa bits, over magnitudes
    from 2^-60 to 2^60 and values on the rounding ties (x = TF32 value +
    exactly half its ulp)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(20_000) * 2.0 ** rng.integers(-60, 60, 20_000)
    ties = tf32_round(torch.from_numpy(x[:1000].astype(np.float32)))
    ties = ties.view(torch.int32) | 0x1000          # the half-ulp bit set
    x = torch.cat([torch.from_numpy(x.astype(np.float32)),
                   ties.view(torch.float32)])
    hi, lo = tf32_split(x)
    # 10 explicit mantissa bits: the low 13 of 23 are 0
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(err <= 2.0 ** -21 * x.double().abs())
    # hi alone: within half a TF32 ulp, 2^-11 |x|
    assert torch.all((x.double() - hi.double()).abs()
                     <= 2.0 ** -11 * x.double().abs())
    # ties round away from zero, as cvt.rna does
    tie = x[-1000:]
    assert torch.all(tf32_round(tie).abs() > tie.abs())


def test_3xtf32_product_is_float32_accurate():
    """A 3xTF32 product of fp32 matrices is within a few fp32 roundings of
    the float64 product, where one TF32 product is not."""
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((64, 128), (128, 64)))
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs())
    err3 = ((mm3(a, b).double() - exact).abs() / scale).max().item()
    err1 = ((tf32_round(a) @ tf32_round(b)).double() - exact).abs() / scale
    assert err3 < 2 ** -20
    assert err1.max().item() > 2 ** -13


# --- the kernels, emulated tile by tile -----------------------------------

def _visible(qi, kj, S, causal, window):
    """(len qi, len kj) bool: the kernels' mask (pairs past S too)."""
    m = (qi[:, None] < S) & (kj[None, :] < S)
    if causal:
        m &= kj[None, :] <= qi[:, None]
    if window:
        m &= qi[:, None] - kj[None, :] < window
    return m


def _pad(x, S_pad):
    """(B, S, n, hd) zero-padded along S, as rows past S are staged."""
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, S_pad - x.shape[1]))


def fp32_forward_tiled(q, k, v, causal, window, plan):
    """csrc/flash_attention.cu's arithmetic: per ``plan.rows`` query tile,
    key tiles of ``plan.step`` from the window's first to the diagonal's,
    S = Q K^T in 3xTF32 scaled and masked to -1e30, the online softmax with
    __expf's role taken by exp, O += P V in 3xTF32; O / max(l, 1e-30) and
    LSE m + log l."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    rows, bk = plan.rows, plan.step
    S_pad = -(-S // max(rows, bk)) * max(rows, bk) + bk
    qf = _pad(q, S_pad).transpose(1, 2)
    kf = _pad(k, S_pad).repeat_interleave(G, dim=2).transpose(1, 2)
    vf = _pad(v, S_pad).repeat_interleave(G, dim=2).transpose(1, 2)
    out = torch.zeros((B, H, S, hd))
    lse = torch.zeros((B, H, S))
    scale = hd ** -0.5
    for q0 in range(0, S, rows):
        qi = torch.arange(q0, q0 + rows)
        Q = qf[:, :, q0:q0 + rows]
        m = torch.full((B, H, rows, 1), tfa.NEG_INF)
        l = torch.zeros((B, H, rows, 1))
        acc = torch.zeros((B, H, rows, hd))
        k_end = min(S, q0 + rows) if causal else S
        kt0 = max(0, q0 - window + 1) // bk if window else 0
        for k0 in range(kt0 * bk, k_end, bk):
            kj = torch.arange(k0, k0 + bk)
            s = mm3(Q, kf[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
            s = s.masked_fill(~_visible(qi, kj, S, causal, window),
                              tfa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + mm3(p, vf[:, :, k0:k0 + bk])
            m = m_new
        n = min(rows, S - q0)
        out[:, :, q0:q0 + n] = (acc / l.clamp_min(1e-30))[:, :, :n]
        lse[:, :, q0:q0 + n] = (m + torch.log(l.clamp_min(1e-30)))[..., 0][
            :, :, :n]
    return out.transpose(1, 2), lse


def fp32_backward_tiled(q, k, v, out, lse, dy, causal, window, plan):
    """csrc/flash_attention_bwd.cu's arithmetic, both kinds of block:
    dK/dV per (``plan.rows`` key tile, KV head, split of its query heads),
    stepping over ``plan.step``-row query tiles of each of the split's
    heads, delta recomputed from the staged rows, S^T and dP^T, dV += P^T dO
    and dK += dS^T Q in 3xTF32, the splits' partials summed in split order;
    dQ per ``plan.rows`` query tile, stepping over key tiles, dQ += dS K."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    rows, M, splits = plan.rows, plan.step, plan.splits
    scale = hd ** -0.5
    S_pad = -(-S // max(rows, M)) * max(rows, M) + M
    qf, df, of = (_pad(t, S_pad) for t in (q, dy, out))
    kf, vf = _pad(k, S_pad), _pad(v, S_pad)
    lsef = torch.nn.functional.pad(lse, (0, S_pad - S))
    dq = torch.zeros((B, S, H, hd))
    dk = torch.zeros((B, S, KV, hd))
    dv = torch.zeros((B, S, KV, hd))
    heads = G // splits
    for k0 in range(0, S, rows):
        kj = torch.arange(k0, k0 + rows)
        qt0 = k0 // M if causal else 0
        q_end = min(S, k0 + rows + window - 1) if window else S
        for hk in range(KV):
            K, V = kf[:, k0:k0 + rows, hk], vf[:, k0:k0 + rows, hk]
            part_k, part_v = [], []
            for sp in range(splits):
                pk = torch.zeros((B, rows, hd))
                pv = torch.zeros((B, rows, hd))
                for h in range(hk * G + sp * heads, hk * G + (sp + 1) * heads):
                    for q0 in range(qt0 * M, q_end, M):
                        qi = torch.arange(q0, q0 + M)
                        Q, dO = qf[:, q0:q0 + M, h], df[:, q0:q0 + M, h]
                        delta = (dO * of[:, q0:q0 + M, h]).sum(-1)   # (B, M)
                        st = mm3(K, Q.transpose(1, 2))               # (B, n, M)
                        p = torch.exp(st * scale - lsef[:, h, q0:q0 + M][:, None])
                        p = p.masked_fill(~_visible(qi, kj, S, causal,
                                                    window).T, 0.0)
                        dpt = mm3(V, dO.transpose(1, 2))
                        ds = p * (dpt - delta[:, None])
                        pv += mm3(p, dO)
                        pk += mm3(ds, Q)
                part_k.append(pk)
                part_v.append(pv)
            sk, sv = part_k[0], part_v[0]
            for pk, pv in zip(part_k[1:], part_v[1:]):
                sk, sv = sk + pk, sv + pv
            n = min(rows, S - k0)
            dk[:, k0:k0 + n, hk] = (sk * scale)[:, :n]
            dv[:, k0:k0 + n, hk] = sv[:, :n]
    for q0 in range(0, S, rows):
        qi = torch.arange(q0, q0 + rows)
        k_end = min(S, q0 + rows) if causal else S
        kt0 = max(0, q0 - window + 1) // M if window else 0
        for h in range(H):
            Q, dO = qf[:, q0:q0 + rows, h], df[:, q0:q0 + rows, h]
            delta = (dO * of[:, q0:q0 + rows, h]).sum(-1)
            L = lsef[:, h, q0:q0 + rows]
            acc = torch.zeros((B, rows, hd))
            for k0 in range(kt0 * M, k_end, M):
                kj = torch.arange(k0, k0 + M)
                K, V = kf[:, k0:k0 + M, h // G], vf[:, k0:k0 + M, h // G]
                p = torch.exp(mm3(Q, K.transpose(1, 2)) * scale - L[..., None])
                p = p.masked_fill(~_visible(qi, kj, S, causal, window), 0.0)
                ds = p * (mm3(dO, V.transpose(1, 2)) - delta[..., None])
                acc += mm3(ds, K)
            n = min(rows, S - q0)
            dq[:, q0:q0 + n, h] = (acc * scale)[:, :n]
    return dq, dk, dv


def _inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, n, hd)).astype(np.float32)
            for n in (H, KV, KV, H)]


def _jax_attention(q, k, v, causal, window):
    """The JAX package's attention: the kernel reference without a window,
    the layers' masked GQA attention with one."""
    G = q.shape[2] // k.shape[2]
    if not window:
        return jref.flash_attention_ref(q, jnp.repeat(k, G, axis=2),
                                        jnp.repeat(v, G, axis=2),
                                        causal=causal)
    pos = jnp.arange(q.shape[1])
    B, S, H, hd = q.shape
    return jlayers.gqa_attend(q, k, v, jlayers._mask(pos, pos, True, window)[
        None, None]).reshape(B, S, H, hd)


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (B, S, H, KV, hd, causal, window): hd 32, 112 and 256; G 1 and 8; causal
# and not; windows over ragged S (no S is a multiple of any tile)
CASES = [(2, 100, 2, 2, 32, True, 0), (1, 77, 8, 1, 32, False, 0),
         (1, 90, 8, 1, 112, True, 0), (2, 70, 2, 2, 112, False, 0),
         (1, 50, 2, 2, 256, True, 0), (1, 45, 8, 1, 256, False, 0),
         (2, 150, 8, 1, 32, True, 33), (1, 130, 2, 2, 112, True, 50),
         (1, 75, 8, 1, 256, True, 17)]
# each case under the plan a full card gives it (small tiles, heads split)
# and under a one-SM card's (64-row tiles, no split)
N_SMS = (132, 1)


@pytest.mark.parametrize("n_sm", N_SMS)
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", CASES)
def test_emulated_forward_matches_jax(B, S, H, KV, hd, causal, window, n_sm):
    """The forward's tiles in 3xTF32 against the JAX reference (output) and
    the plain version's log-sum-exp, within 2e-5."""
    q, k, v, _ = _inputs(B, S, H, KV, hd, 1)
    plan = tfa.fp32_plan(B, S, H, KV, hd, n_sm=n_sm)
    out, lse = fp32_forward_tiled(*map(torch.from_numpy, (q, k, v)), causal,
                                  window, plan)
    want = _jax_attention(*map(jnp.asarray, (q, k, v)), causal, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    _, lse_ref = tfa.flash_attention_plain_lse(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("n_sm", N_SMS)
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", CASES)
def test_emulated_backward_matches_the_vjp(B, S, H, KV, hd, causal, window,
                                           n_sm):
    """The backward's two kinds of block in 3xTF32, from the emulated
    forward's output and LSE: dq, dk and dv each within 2e-5 relative RMS
    of ``jax.vjp`` of the JAX attention and of the closed form."""
    q, k, v, dy = _inputs(B, S, H, KV, hd, 2)
    qt, kt, vt, dt = map(torch.from_numpy, (q, k, v, dy))
    plan = tfa.fp32_plan(B, S, H, KV, hd, True, n_sm=n_sm)
    out, lse = fp32_forward_tiled(qt, kt, vt, causal, window,
                                  tfa.fp32_plan(B, S, H, KV, hd, n_sm=n_sm))
    got = fp32_backward_tiled(qt, kt, vt, out, lse, dt, causal, window, plan)
    _, vjp = jax.vjp(lambda q, k, v: _jax_attention(q, k, v, causal, window),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dy))
    plain = tfa.flash_attention_backward(qt, kt, vt, dt, causal, window)
    for g, w, p in zip(got, want, plain):
        assert g.shape == p.shape
        assert _rel_rms(g.numpy(), np.asarray(w)) <= TOL
        assert _rel_rms(g.numpy(), p.numpy()) <= TOL


# --- the plan ---------------------------------------------------------------

# the shapes the port gives K2's fp32 route: launch.train's reduced default,
# the gpt gradient check, the serving and window shapes the card times
TRAIN = (4, 128, 4, 2, 32)
SERVING = [(4, 256, 32, 4, 128), (1, 4096, 32, 4, 128), (1, 4096, 64, 8, 112),
           (1, 2048, 16, 8, 256), (4, 1500, 16, 16, 64), (4, 1280, 12, 2, 128),
           (1, 4096, 16, 8, 256), (2, 1024, 12, 12, 64)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("hd", tfa.SUPPORTED_HEAD_DIMS)
def test_plan_fits_a_block_at_every_head_dim(hd, backward):
    """Every plan the rule can give fits 227 KB and 1024 threads, takes
    rows and steps that are multiples of 16 and splits that divide G, and
    states its shared memory as the source computes it."""
    for B, S, H, KV in [(1, 1, 1, 1), (4, 128, 4, 2), (2, 1000, 16, 2),
                        (1, 4096, 32, 4), (8, 333, 12, 12), (1, 77, 8, 1),
                        (3, 4096, 64, 8)]:
        for n_sm in (1, 132, 10_000):
            p = tfa.fp32_plan(B, S, H, KV, hd, backward, n_sm=n_sm)
            assert p.rows in tfa.FP32_ROWS and p.step % 16 == 0
            assert p.smem == tfa.fp32_smem_bytes(hd, p.rows, backward)
            assert p.smem <= trn.SMEM_LIMIT
            assert p.warps * 32 <= 1024 and p.warps == p.split * p.rows // 16
            assert (H // KV) % p.splits == 0
            tiles = -(-S // p.rows)
            assert p.q_blocks == tiles * H * B
            assert p.kv_blocks == (tiles * KV * B * p.splits if backward
                                   else 0)
            if backward and hd == 256:
                assert p.rows <= 32
    assert tfa.fp32_plan(1, 64, 1, 1, hd) == tfa.fp32_plan(1, 64, 1, 1, hd)


def test_plan_fills_the_card_at_launch_train():
    """launch.train's (4, 128, 4/2, 32): at least 128 forward blocks, and
    at least 128 dK/dV and 128 dQ blocks in the one backward launch."""
    fwd = tfa.fp32_plan(*TRAIN)
    bwd = tfa.fp32_plan(*TRAIN, backward=True)
    assert fwd.q_blocks >= 128
    assert bwd.kv_blocks >= 128 and bwd.q_blocks >= 128
    assert (fwd.rows, bwd.rows, bwd.splits) == (16, 16, 2)


@pytest.mark.parametrize("shape", SERVING)
def test_plan_keeps_64_row_tiles_at_the_serving_shapes(shape):
    """Shapes that fill the card keep the forward's 64-row tiles (fewer
    re-reads of K and V); at hd 256 the backward's 32-row ones."""
    B, S, H, KV, hd = shape
    assert tfa.fp32_plan(*shape).rows == 64
    bwd = tfa.fp32_plan(*shape, backward=True)
    assert bwd.rows == (32 if hd == 256 else 64)


def test_plan_splits_query_heads_before_it_shrinks_tiles():
    """(4, 256, 32/4, 128): 64 dK/dV blocks at 64 rows; splitting each KV
    head's 8 query heads in 4 gives 256 without smaller tiles."""
    p = tfa.fp32_plan(4, 256, 32, 4, 128, True)
    assert (p.rows, p.splits, p.kv_blocks, p.q_blocks) == (64, 4, 256, 512)
    assert tfa.fp32_plan(1, 4096, 32, 4, 128, True).splits == 1


def test_cp_async16_check_is_a_pure_function_of_the_layout():
    shape = (2, 9, 4, 32)
    assert tfa.cp_async16_ok(shape, (1152, 128, 32, 1), 0)
    assert not tfa.cp_async16_ok(shape, (1152, 128, 32, 1), 8)
    assert not tfa.cp_async16_ok(shape, (1152, 130, 32, 1), 0)
    # a head stride of 34 floats is no multiple of 16 bytes ...
    assert not tfa.cp_async16_ok(shape, (1224, 136, 34, 1), 0)
    # ... unless there is one head, which is never stepped over
    assert tfa.cp_async16_ok((1, 9, 1, 32), (306, 136, 34, 1), 0)


def test_fp32_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_fp32(q, q, q, q, torch.zeros(1, 2, 8), q)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("rows", [16, 32, 64])
def test_flash_blocks_sweep(rows):
    """tests/test_kernels.py's block sweep on the fp32 route's tiling: at
    the JAX test's shape and inputs, every query tile the plan can pick
    with key tiles of 32, 64 and 128 keeps the JAX reference within the
    JAX test's 2e-4."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, 128, 1, 64)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    plan = tfa.fp32_plan(1, 128, 1, 1, 64)
    for step in (32, 64, 128):
        out, _ = fp32_forward_tiled(*map(torch.from_numpy, (q, k, v)), True,
                                    0, plan._replace(rows=rows, step=step))
        np.testing.assert_allclose(out.numpy(), want, atol=2e-4, rtol=2e-4)
