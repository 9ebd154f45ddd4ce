"""K2 with a causal sliding window, and its float32 backward, against the
JAX package on the CPU.

The Pallas kernel has no window: the JAX package computes a windowed layer
in its XLA attention (``layers._mask`` with ``gqa_attend`` or, for long
sequences, ``gqa_attend_chunked``). The port computes the same function in
K2, so K2's plain versions (forward, LSE and the closed-form backward that
both backward kernels are held to on the card) are held here against those
JAX functions and ``jax.vjp`` of them, on numpy-seeded inputs. The kernels'
loop bounds (the first key tile of a query tile's window, the last query
tile a key tile's window reaches) are emulated tile by tile in plain torch
and held to the plain version. The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: fp32 2e-4 (the JAX kernel test's; summation order only), bf16
the JAX kernel test's 5e-2 (output rounding; the JAX layers also round the
scores to bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from torch_parity import one_thread_module  # noqa: F401 (one thread)

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
TOL = {jnp.float32: 2e-4, jnp.bfloat16: 5e-2}


def _inputs(B, S, H, KV, hd, dtype, seed):
    """q, k, v (and dy) as JAX arrays and torch tensors of equal values."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (H, KV, KV, H):
        j = jnp.asarray(rng.normal(size=(B, S, n, hd)).astype(np.float32),
                        dtype)
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(TORCH_DTYPE[dtype])))
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_attention(q, k, v, window, chunked=False):
    """The JAX layers' causal windowed attention, (B, S, H, hd)."""
    B, S, H, hd = q.shape
    pos = jnp.arange(S)
    if chunked:
        y = jlayers.gqa_attend_chunked(q, k, v, pos, pos, causal=True,
                                       window=window)
    else:
        y = jlayers.gqa_attend(q, k, v,
                               jlayers._mask(pos, pos, True, window)[None,
                                                                     None])
    return y.reshape(B, S, H, hd)


# S 200 and 77 are no multiple of any tile (64, 128); windows below S that
# are not tile multiples, equal to S and above it; G = 1, 2 and 10
# (recurrentgemma's 10 over 1)
CASES = [(1, 200, 2, 2, 32, 50), (2, 200, 4, 2, 64, 129),
         (1, 77, 10, 1, 32, 16), (1, 128, 4, 2, 32, 128),
         (1, 96, 4, 4, 32, 200), (2, 65, 10, 1, 64, 64)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,window", CASES)
def test_windowed_plain_matches_the_jax_layers(B, S, H, KV, hd, window,
                                               dtype):
    (qj, qt), (kj, kt), (vj, vt), _ = _inputs(B, S, H, KV, hd, dtype, 1)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    want = _jax_attention(qj, kj, vj, window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("window", [24, 100, 300])
def test_windowed_plain_matches_the_chunked_jax_path(monkeypatch, window):
    """The JAX layers' long-sequence path (q blocks with per-block K/V
    slices from each block's window), at 40-row blocks here."""
    monkeypatch.setattr(jlayers, "ATTN_CHUNK", 40)
    (qj, qt), (kj, kt), (vj, vt), _ = _inputs(1, 150, 8, 2, 32, jnp.float32,
                                              2)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    want = _jax_attention(qj, kj, vj, window, chunked=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("B,S,H,KV,hd,window", CASES)
def test_windowed_backward_is_the_vjp(B, S, H, KV, hd, window):
    """The closed form with a window (both backward kernels' plain version)
    against ``jax.vjp`` of the JAX layers' attention, fp32."""
    (qj, qt), (kj, kt), (vj, vt), (dj, dt) = _inputs(B, S, H, KV, hd,
                                                     jnp.float32, 3)
    _, vjp = jax.vjp(lambda q, k, v: _jax_attention(q, k, v, window),
                     qj, kj, vj)
    want = vjp(dj)
    got = tfa.flash_attention_backward(qt, kt, vt, dt, True, window)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_f32(g), _f32(w), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("window", [0, 33, 64])
def test_windowed_lse_is_the_logsumexp_of_the_masked_scores(window):
    (qj, qt), (kj, kt), (vj, vt), _ = _inputs(2, 100, 4, 2, 32, jnp.float32,
                                              4)
    out, lse = tfa.flash_attention_plain_lse(qt, kt, vt, causal=True,
                                             window=window)
    pos = jnp.arange(100)
    s = jnp.einsum("bqhd,bkhd->bhqk", qj, jnp.repeat(kj, 2, axis=2)) \
        * 32 ** -0.5
    s = jnp.where(jlayers._mask(pos, pos, True, window)[None, None], s,
                  -jnp.inf)
    np.testing.assert_allclose(lse.numpy(), np.asarray(
        jax.nn.logsumexp(s, axis=-1)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), tfa.flash_attention_plain(
        qt, kt, vt, causal=True, window=window).numpy(), atol=1e-6,
        rtol=1e-6)


# --- the kernels' loop bounds, tile by tile -------------------------------

def _tiled_forward(q, k, v, window, bq, bk):
    """The forward kernels' loops in plain torch: per bq-row query tile, key
    tiles from the one that holds q0 - window + 1 to the diagonal, an online
    softmax with the -1e30 mask (a row's fully masked early tiles add
    exp(0) = 1 each until its first unmasked score scales them away)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2) * hd ** -0.5
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    out = torch.zeros(B, H, S, hd)
    lse = torch.zeros(B, H, S)
    for q0 in range(0, S, bq):
        rows = torch.arange(q0, min(S, q0 + bq))[:, None]
        m = torch.full((B, H, len(rows), 1), tfa.NEG_INF)
        l = torch.zeros(B, H, len(rows), 1)
        acc = torch.zeros(B, H, len(rows), hd)
        kt0 = max(0, q0 - window + 1) // bk if window else 0
        for k0 in range(kt0 * bk, min(S, q0 + bq), bk):
            cols = torch.arange(k0, min(S, k0 + bk))[None, :]
            s = qf[:, :, rows[:, 0]] @ kf[:, :, cols[0]].transpose(-1, -2)
            seen = cols <= rows
            if window:
                seen &= rows - cols < window
            s = s.masked_fill(~seen, tfa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, cols[0]]
            m = m_new
        out[:, :, rows[:, 0]] = acc / l
        lse[:, :, rows[:, 0]] = (m + torch.log(l))[..., 0]
    return out.transpose(1, 2), lse


def _tiled_backward(q, k, v, dy, lse, window, bq, bk):
    """The backward kernels' loops: dK and dV per bk-key tile over the bq-row
    query tiles from the key tile's own to the last its window reaches
    (k0 + bk - 1 + window - 1); dQ per bq-row query tile over the key tiles
    from its window's first; P from the LSE, masked to 0."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf, kf, vf, df = (t.float() for t in (q, k, v, dy))
    out = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    delta = (df * out.float()).sum(-1).transpose(1, 2)
    dq, dk, dv = (torch.zeros(t.shape) for t in (q, k, v))

    def p_ds(h, qs, ks):
        hk = h // G
        s = qf[:, qs, h] @ kf[:, ks, hk].transpose(1, 2)      # (B, q, k)
        seen = (ks[None] <= qs[:, None])
        if window:
            seen &= qs[:, None] - ks[None] < window
        p = torch.exp(s * scale - lse[:, h, qs][..., None]) * seen
        dp = df[:, qs, h] @ vf[:, ks, hk].transpose(1, 2)
        return p, p * (dp - delta[:, h, qs][..., None])

    for k0 in range(0, S, bk):
        ks = torch.arange(k0, min(S, k0 + bk))
        q_end = min(S, k0 + bk + window - 1) if window else S
        for h in range(H):
            for q0 in range(k0 // bq * bq, q_end, bq):
                qs = torch.arange(q0, min(S, q0 + bq))
                p, ds = p_ds(h, qs, ks)
                dv[:, ks, h // G] += p.transpose(1, 2) @ df[:, qs, h]
                dk[:, ks, h // G] += ds.transpose(1, 2) @ qf[:, qs, h] * scale
    for q0 in range(0, S, bq):
        qs = torch.arange(q0, min(S, q0 + bq))
        kt0 = max(0, q0 - window + 1) // bk if window else 0
        for h in range(H):
            for k0 in range(kt0 * bk, min(S, q0 + bq), bk):
                ks = torch.arange(k0, min(S, k0 + bk))
                _, ds = p_ds(h, qs, ks)
                dq[:, qs, h] += ds @ kf[:, ks, h // G] * scale
    return dq, dk, dv


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 128), (32, 32),
                                   (128, 64), (64, 128)])
@pytest.mark.parametrize("S,window", [(200, 50), (300, 129), (130, 1),
                                      (190, 64)])
def test_kernel_loop_bounds_cover_the_window(S, window, bq, bk):
    """Every (query, key) pair the window lets through lies in a visited
    tile, in both directions, at the kernels' tiles (fp32: 64 x 64, hd 256
    32 x 32; bf16 forward 128 x 128, hd 256 128 x 64; bf16 backward 128
    keys x 64 queries, dQ 128 x 64): the tiled loops give the plain
    version's output, LSE and gradients."""
    (_, qt), (_, kt), (_, vt), (_, dt) = _inputs(1, S, 4, 2, 32,
                                                 jnp.float32, 5)
    out, lse = _tiled_forward(qt, kt, vt, window, bq, bk)
    want, want_lse = tfa.flash_attention_plain_lse(qt, kt, vt, causal=True,
                                                   window=window)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    got = _tiled_backward(qt, kt, vt, dt, want_lse, window, bq, bk)
    for g, w in zip(got, tfa.flash_attention_backward(qt, kt, vt, dt, True,
                                                      window)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


# --- counts and refusals ---------------------------------------------------

@pytest.mark.parametrize("S,window", [(1, 0), (50, 0), (50, 7), (50, 49),
                                      (50, 50), (50, 80), (4096, 1024)])
def test_pairs_count_the_window(S, window):
    """The pairs the FLOP formulas count are the mask's (a window of at
    least S is the causal triangle); gemma3-12b's local layer at 1 x 4096:
    3,670,528 pairs a head."""
    want = int(jlayers._mask(jnp.arange(S), jnp.arange(S), True,
                             window).sum())
    assert ops.attention_pairs(S, S, True, window) == want
    if (S, window) == (4096, 1024):
        assert want == 3_670_528
    assert ops.attention_pairs(S, S, False) == S * S


def test_windowed_flop_formula_counts_the_windowed_pairs():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    B, S, H, KV, hd, window = 2, 48, 4, 2, 64, 10
    q, k = torch.randn(B, S, H, hd), torch.randn(B, S, KV, hd)
    pairs = ops.attention_pairs(S, S, True, window)
    with FakeTensorMode() as mode, FlopCounterMode(display=False) as fc:
        qf, kf = mode.from_tensor(q), mode.from_tensor(k)
        out, lse = ops.flash_attention_op(qf, kf, kf, window, True, True)
        ops.flash_attention_backward_op(qf, kf, kf, out, lse, qf, True,
                                        window)
    assert fc.get_total_flops() == 14 * B * H * hd * pairs


def test_window_without_causal_or_below_zero_raises():
    q = torch.randn(1, 16, 2, 32)
    for kw in (dict(causal=False, window=4), dict(causal=True, window=-1)):
        with pytest.raises(ValueError, match="window"):
            ops.flash_attention(q, q, q, **kw)
        with pytest.raises(ValueError, match="window"):
            tfa.check_window(**kw)


def test_kernel_window_drops_a_window_of_at_least_s():
    assert [tfa.kernel_window(w, 100) for w in (0, 1, 99, 100, 4096)] == \
        [0, 1, 99, 0, 0]
    with pytest.raises(ValueError):
        tfa.kernel_window(-1, 100)
    (_, qt), (_, kt), (_, vt), _ = _inputs(1, 40, 2, 1, 32, jnp.float32, 6)
    torch.testing.assert_close(
        tfa.flash_attention_plain(qt, kt, vt, causal=True, window=40),
        tfa.flash_attention_plain(qt, kt, vt, causal=True), atol=0, rtol=0)


def test_windowed_autograd_on_the_cpu_is_the_closed_form():
    """ops.flash_attention with a window under autograd on CPU tensors: the
    plain version's gradients equal the closed form's (fp32), and nothing
    launches."""
    (_, qt), (_, kt), (_, vt), (_, dt) = _inputs(1, 70, 4, 2, 32,
                                                 jnp.float32, 7)
    ops.reset_launch_counts()
    xs = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    got = torch.autograd.grad(ops.flash_attention(*xs, causal=True,
                                                  window=20), xs, dt)
    for g, w in zip(got, tfa.flash_attention_backward(qt, kt, vt, dt, True,
                                                      20)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    assert all(n == 0 for n in ops.launch_counts().values())
