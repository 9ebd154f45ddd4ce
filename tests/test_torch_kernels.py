"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU, ``ops`` routes to each kernel's plain PyTorch version; those
are held against the JAX Pallas RMSNorm kernel (interpret mode), the JAX
oracles in ``repro.kernels.ref`` and the model's ``gqa_attend``. The
Pallas flash kernel does not trace under the installed JAX (``pl.load`` is
gone), so K2's plain version is held against the oracle and the model path
instead. Inputs are made from a numpy seed, cast in JAX, and handed to
torch through float32 numpy, so both sides see identical values.

The kernels themselves are tested on the card by ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models import layers as jlayers
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref as tref
from repro_torch.kernels import rmsnorm as trn
from torch_parity import one_thread_module  # noqa: F401 (one thread)

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _pair(a, dtype):
    """One numpy array as (jax array, torch tensor) holding equal values."""
    j = jnp.asarray(a.astype(np.float32), dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH_DTYPE[dtype])
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --- K1: RMSNorm --------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 128), (2, 16, 256), (1, 7, 384),
                                   (3, 5, 8, 128), (4, 768), (3, 3840),
                                   (4, 4096), (2, 8192)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=shape), dtype)
    # non-zero scales: a kernel that dropped (1 + scale) would fail
    sj, st = _pair(rng.normal(size=shape[-1:]) * 0.1, dtype)
    got = ops.rmsnorm(xt, st)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    # the JAX test's tolerances: fp32 rounding, or one bf16 output ulp
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    for want in (pallas_rmsnorm(xj, sj, interpret=True),
                 jref.rmsnorm_ref(xj, sj)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


# every registered d_model (src/repro_torch/configs and the JAX zoo)
D_MODELS = (768, 1024, 1536, 2048, 2560, 3840, 4096, 5376, 7168, 8192)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", D_MODELS)
def test_rmsnorm_plan_gives_every_block_rows_and_fits(D, dtype):
    n_sm = 132
    es = dtype.itemsize
    chunks = D * es // 16
    for rows in range(1, 8193):
        p = trn.plan(rows, D, dtype, n_sm)
        one_wave = n_sm * min(32, 2048 // p.threads)
        assert p.name == ("rows" if rows <= one_wave else "ring")
        assert 1 <= p.grid <= rows          # no block without a row
        assert p.threads % 32 == 0 and p.threads <= 1024
        assert chunks <= 2 * p.threads      # one or two 16-byte chunks each
        if p.name == "rows":
            assert (p.grid, p.stages, p.smem) == (rows, 0, 0)
        else:
            assert p.grid <= n_sm * 16
            assert 2 <= p.stages <= 4
            assert p.smem == p.stages * D * es + 256 + 8 * p.stages
            assert p.smem <= 232_448        # the ring fits a block's share
            # an SM's blocks fit its threads (64 registers each) and memory
            per_sm = -(-p.grid // n_sm)
            assert per_sm * p.threads <= 2048 or p.grid == rows
            assert per_sm * (p.smem + 1024) <= 233_472 or p.grid == rows
    # plan() is pure: the same arguments give the same plan
    assert trn.plan(8192, D, dtype, n_sm) == trn.ring_plan(8192, D, es, n_sm)
    assert trn.plan(4, D, dtype, n_sm) == trn.rows_plan(4, D, es)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", (128,) + D_MODELS)
def test_rmsnorm_backward_plan_gives_every_block_rows_and_fits(D, dtype):
    """The backward's plan: a row's threads as the forward's (whole warps,
    two 16-byte chunks each at most), slots of rows filling a block of at
    most 512 threads (or one row of more), a grid of the blocks the card
    holds at 1024 threads an SM and never a block without a row, and the
    slots' dscale partials within a block's shared memory."""
    n_sm = 132
    tr = trn._threads(D, dtype.itemsize)
    for rows in (1, 2, 4, 15, 16, 17, 133, 1000, 4096, 8192, 100_000):
        p = trn.backward_plan(rows, D, dtype, n_sm)
        assert p.threads == p.slots * tr and p.threads % 32 == 0
        assert p.threads <= max(512, tr) and p.slots <= rows
        assert 1 <= p.grid and (p.grid - 1) * p.slots < rows
        assert p.grid <= n_sm * max(1, 1024 // p.threads)
        assert p.smem == 512 + (p.slots * D * 4 if p.slots > 1 else 0)
        assert p.smem <= trn.SMEM_LIMIT
    # gpt's training rows: 8 rows of 64 threads a block, 2 blocks an SM
    assert trn.backward_plan(8192, 768, torch.bfloat16, 132) == \
        trn.BwdPlan(grid=264, threads=512, slots=8, smem=512 + 8 * 768 * 4)


def _rmsnorm_bwd_blocked(x, scale, dy, eps, n_sm):
    """The backward kernel's arithmetic in plain torch, in its order: rows
    dealt to (block, iteration, slot) by ``backward_plan``; per row r from
    sum x^2 and dx from sum g x, both fp32; each slot's dy * x * r summed
    over its rows in fp32, a block's slots summed in slot order into its
    partial row; the partials summed by column as the column-sum launch
    does (32 strided groups, then the groups in order); casts last."""
    rows, D = x.shape
    p = trn.backward_plan(rows, D, x.dtype, n_sm)
    xf, df, w = x.float(), dy.float(), 1.0 + scale.float()
    g = df * w
    r = torch.rsqrt(xf.square().sum(-1, keepdim=True) / D + eps)
    dx = r * (g - xf * (r * r * (g * xf).sum(-1, keepdim=True) / D))
    contrib = df * xf * r
    partial = torch.zeros((p.grid, D))
    step = p.grid * p.slots
    for b in range(p.grid):
        slots = torch.zeros((p.slots, D))
        for it in range(-(-(rows - b * p.slots) // step)):
            for sl in range(p.slots):
                row = b * p.slots + it * step + sl
                if row < rows:
                    slots[sl] += contrib[row]
        for sl in range(p.slots):
            partial[b] += slots[sl]
    groups = torch.zeros((32, D))
    for y in range(32):
        for q in range(y, p.grid, 32):
            groups[y] += partial[q]
    dscale = torch.zeros(D)
    for y in range(32):
        dscale += groups[y]
    return dx.to(x.dtype), dscale.to(scale.dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("rows,D,n_sm", [(1000, 256, 4), (130, 768, 2),
                                         (7, 4096, 132)])
def test_rmsnorm_backward_decomposition_is_the_vjp(rows, D, n_sm, dtype):
    """K1's backward as the kernel splits it (row passes, per-block dscale
    partials, a column sum) against ``jax.vjp`` of the JAX package's
    RMSNorm reference on the same values: fp32 within 1e-5, bf16 within
    the forward's 3e-2 (dx) and 1e-2 relative (dscale, one bf16 rounding
    of a sum of many rows)."""
    rng = np.random.default_rng(13)
    (xj, xt), (dj, dt) = (_pair(rng.normal(size=(rows, D)), dtype)
                          for _ in range(2))
    sj, st = _pair(rng.normal(size=(D,)) * 0.1, dtype)
    _, vjp = jax.vjp(jref.rmsnorm_ref, xj, sj)
    want_dx, want_ds = vjp(dj)
    dx, ds = _rmsnorm_bwd_blocked(xt, st, dt, 1e-6, n_sm)
    assert dx.dtype == ds.dtype == TORCH_DTYPE[dtype]
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    np.testing.assert_allclose(_f32(dx), _f32(want_dx), atol=tol, rtol=tol)
    tol_ds = 1e-5 if dtype == jnp.float32 else 1e-2
    np.testing.assert_allclose(_f32(ds), _f32(want_ds), rtol=tol_ds,
                               atol=tol_ds * np.abs(_f32(want_ds)).max())
    # and the closed form (the kernel's plain version) agrees
    pdx, pds = trn.rmsnorm_backward(xt, st, dt)
    np.testing.assert_allclose(_f32(pdx), _f32(dx), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(pds), _f32(ds), rtol=tol_ds,
                               atol=tol_ds * np.abs(_f32(ds)).max())


def test_rmsnorm_plan_refuses_what_no_plan_takes():
    with pytest.raises(TypeError, match="float16"):
        trn.plan(4, 4096, torch.float16, 132)
    with pytest.raises(ValueError, match="at most 32768 bytes"):
        trn.plan(4, 16384, torch.float32, 132)   # 64 KB rows
    with pytest.raises(ValueError, match="rows=0"):
        trn.plan(0, 4096, torch.float32, 132)


@pytest.mark.parametrize("args, rule", [
    ((4, 4096, 2, 4096, 0x1002), "aligned base"),
    ((4, 4092, 2, 4096, 0x1000), "rows of a multiple of 16 bytes"),
    ((4, 100, 2, 104, 0x1000), "rows of a multiple of 16 bytes"),
    ((4, 4096, 2, 4100, 0x1000), "row stride"),
    ((4, 4096, 4, 4098, 0x1000), "row stride"),
])
def test_rmsnorm_bulk_copy_check_names_the_rule(args, rule):
    with pytest.raises(ValueError, match=rule):
        trn.check_bulk_copy(*args)


def test_rmsnorm_bulk_copy_check_accepts_aligned_rows():
    for D in D_MODELS:
        for es in (2, 4):
            trn.check_bulk_copy(8, D, es, D, 0x1000)
            trn.check_bulk_copy(8, D, es, D + 64, 0x1000)   # padded rows
    # one row has no stride to step over
    trn.check_bulk_copy(1, 4096, 2, 7, 0x1000)


def test_rmsnorm_as_rows_keeps_row_strided_views():
    big = torch.empty(6, 4160, dtype=torch.bfloat16)
    x = big[:, :4096]
    x2 = trn.as_rows(x)
    assert x2.data_ptr() == big.data_ptr() and x2.stride() == (4160, 1)
    x3 = trn.as_rows(torch.empty(2, 3, 4096))
    assert x3.shape == (6, 4096) and x3.stride() == (4096, 1)
    xt = trn.as_rows(torch.empty(4096, 6).t())      # column-major rows
    assert xt.stride() == (4096, 1)


# --- K2: flash attention ------------------------------------------------

@pytest.mark.parametrize("B,S,H,hd", [(1, 128, 2, 64), (2, 256, 1, 32),
                                      (1, 64, 4, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_matches_jax_ref(B, S, H, hd, causal, dtype):
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng.normal(size=(B, S, H, hd)),
                                          dtype) for _ in range(3))
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    # the JAX test's tolerances (fp32 sum order; bf16 output rounding)
    tol = 2e-4 if dtype == jnp.float32 else 5e-2
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_gqa_matches_gqa_attend(causal):
    """H=8 query heads over KV=2: query head h reads KV head h // 4."""
    B, S, H, KV, hd = 2, 48, 8, 2, 32
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng.normal(size=(B, S, H, hd)), jnp.float32)
    kj, kt = _pair(rng.normal(size=(B, S, KV, hd)), jnp.float32)
    vj, vt = _pair(rng.normal(size=(B, S, KV, hd)), jnp.float32)
    pos = jnp.arange(S)
    mask = jlayers._mask(pos, pos, causal, 0)[None, None]
    want = jlayers.gqa_attend(qj, kj, vj, mask)
    got = ops.flash_attention(qt, kt, vt, causal=causal).reshape(B, S, H * hd)
    # fp32 both sides; only the summation order differs
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def _flash_bf16_p(q, k, v, causal, block_k=128):
    """The tensor-core kernel's arithmetic in plain torch: fp32 scores and
    an online softmax over key tiles of ``block_k``, P rounded to bf16
    before P @ V with an fp32 sum, the normaliser summed from the fp32 P,
    and O / max(l, 1e-30) rounded to q's dtype."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    m = torch.full((B, H, S, 1), tfa.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) * hd ** -0.5
        if causal:
            cols = torch.arange(k0, k0 + s.shape[-1])[None, :]
            s = s.masked_fill(cols > rows, tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0:k0 + block_k]
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("B,S", [(4, 256), (1, 1024)])
def test_bf16_p_keeps_rows_within_the_card_limit(B, S):
    """The bf16 kernel's one numeric change, P in bf16 before P @ V, at the
    main path's heads (32 over 4, hd 128): the worst output row stays
    within 5e-3 relative error of the plain version, half the 1e-2 limit
    that the card's check holds the kernel to."""
    H, KV, hd = 32, 4, 128
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, hd)).astype(
        np.float32)).bfloat16() for n in (H, KV, KV))
    for causal in (True, False):
        got = _flash_bf16_p(q, k, v, causal).float()
        want = tfa.flash_attention_plain(q, k, v, causal=causal).float()
        rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
        assert rel.max().item() <= 5e-3


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 128, 2, 2, 64),
                                         (2, 100, 4, 2, 32)])
def test_plain_lse_is_jax_logsumexp_of_the_reference_scores(B, S, H, KV, hd,
                                                            causal):
    """The log-sum-exp the bf16 forward saves for the backward, in its plain
    version, against ``jax.nn.logsumexp`` of the JAX reference's scaled,
    masked scores (GQA: KV heads repeated as ``jnp.repeat`` does); the
    output is the plain forward's."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    out, lse = tfa.flash_attention_plain_lse(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    kr = jnp.repeat(jnp.asarray(k), H // KV, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kr) * hd ** -0.5
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, None], s,
                      -jnp.inf)
    want = jax.nn.logsumexp(s, axis=-1)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    plain = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-6,
                               rtol=1e-6)


def _flash_bwd_bf16_tiled(q, k, v, dy, causal):
    """The bf16 backward kernels' arithmetic in plain torch, tile by tile:
    the forward's LSE and bf16 output; delta = rowsum(dO * O) in fp32; per
    KV head, 64-key warpgroup tile and query head of its group, query tiles
    of 64 (from the key tile's own when causal): P^T = exp(S^T scale - LSE)
    in fp32, masked to 0; dV += bf16(P^T) dO; dP^T = V dO^T;
    dS^T = P^T (dP^T - delta) rounded to bf16 for dK += dS^T Q, and the
    same bf16 dS for dQ += dS K, which the dQ kernel sums in fp32 over 64-key
    tiles of its own; dK and dQ scaled at the end and everything cast to
    bf16."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    out, lse = tfa.flash_attention_plain_lse(q, k, v, causal=causal)
    qf, kf, vf, df = (t.float() for t in (q, k, v, dy))
    delta = (df * out.float()).sum(-1).transpose(1, 2)      # (B, H, S)
    dq = torch.zeros((B, S, H, hd))
    dk = torch.zeros((B, S, KV, hd))
    dv = torch.zeros((B, S, KV, hd))
    bq = tfa.BWD_BLOCK_Q
    for hk in range(KV):
        for k0 in range(0, S, 64):                  # a warpgroup's keys
            keys = torch.arange(k0, min(S, k0 + 64))
            K, V = kf[:, keys, hk], vf[:, keys, hk]       # (B, n, hd)
            for h in range(hk * G, (hk + 1) * G):
                first = (k0 // tfa.BWD_BLOCK_K * tfa.BWD_BLOCK_K
                         if causal else 0)
                for q0 in range(first, S, bq):
                    qs = torch.arange(q0, min(S, q0 + bq))
                    Q, dO = qf[:, qs, h], df[:, qs, h]    # (B, m, hd)
                    st = K @ Q.transpose(1, 2)            # (B, n, m)
                    p = torch.exp(st * scale - lse[:, h, qs][:, None])
                    if causal:
                        p = p.masked_fill(keys[:, None] > qs[None], 0.0)
                    dv[:, keys, hk] += p.bfloat16().float() @ dO
                    dp = V @ dO.transpose(1, 2)
                    ds = (p * (dp - delta[:, h, qs][:, None])).bfloat16() \
                        .float()
                    dk[:, keys, hk] += ds @ Q
                    dq[:, qs, h] += ds.transpose(1, 2) @ K
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 256, 8, 2, 128),
                                         (2, 200, 4, 4, 64),
                                         (1, 192, 8, 1, 256)])
def test_bf16_backward_tiling_keeps_grads_within_the_card_limit(
        B, S, H, KV, hd, causal):
    """The bf16 backward kernel's numeric changes (P^T and dS rounded to
    bf16, delta from the bf16 output, fp32 sums tile by tile) on bf16
    inputs: each of dq, dk and dv within 5e-3 relative RMS, half the 1e-2
    limit the card's check holds the kernel to, of both the closed form
    (the kernel's plain version) and ``jax.vjp`` of the JAX package's
    attention reference (KV heads repeated, dK and dV summed back)."""
    rng = np.random.default_rng(12)
    q, k, v, dy = (torch.from_numpy(rng.normal(size=(B, S, n, hd)).astype(
        np.float32)).bfloat16() for n in (H, KV, KV, H))
    got = _flash_bwd_bf16_tiled(q, k, v, dy, causal)
    plain = tfa.flash_attention_backward(q, k, v, dy, causal)
    G = H // KV

    def ref(q, k, v):
        return jref.flash_attention_ref(q, jnp.repeat(k, G, axis=2),
                                        jnp.repeat(v, G, axis=2),
                                        causal=causal)
    _, vjp = jax.vjp(ref, *(jnp.asarray(t.float().numpy())
                            for t in (q, k, v)))
    want = vjp(jnp.asarray(dy.float().numpy()))
    for g, p, w in zip(got, plain, want):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape
        assert _rel_rms(g.float().numpy(), p.float().numpy()) <= 5e-3
        assert _rel_rms(g.float().numpy(), np.asarray(w)) <= 5e-3


def test_backward_grids_are_pure_functions():
    # (main: 128-key tiles x query heads (one a block: GQA's G split) x
    # batch; dQ: 128-query tiles x heads x batch)
    assert tfa.backward_grids(8, 1024, 12, 12) == ((8, 12, 8), (8, 12, 8))
    assert tfa.backward_grids(1, 1000, 32, 4) == ((8, 32, 1), (8, 32, 1))
    assert tfa.backward_grids(2, 1, 2, 1) == ((1, 2, 2), (1, 2, 2))
    assert [tfa.backward_splits(H, KV) for H, KV in
            ((12, 12), (32, 4), (64, 8), (16, 16), (32, 16))] == [1, 8, 8, 1, 2]
    assert [tfa.backward_padded_rows(S) for S in (1, 64, 65, 1000, 4096)] \
        == [64, 64, 128, 1024, 4096]


def test_backward_shared_memory_fits_a_block():
    """Every head dim's main and dQ kernels fit the 227 KB a block may use;
    hd 112 takes hd 128's tile; hd 256 holds one ring stage."""
    for dq in (False, True):
        smem = {hd: tfa.backward_smem_bytes(hd, dq)
                for hd in tfa.SUPPORTED_HEAD_DIMS}
        assert all(n <= trn.SMEM_LIMIT for n in smem.values())
        assert smem[112] == smem[128]
        assert smem[32] < smem[64] < smem[128] < smem[256]
    # main: K, V 32 KB each; 2 stages of Q, dO 16 KB each + LSE, delta
    assert tfa.backward_smem_bytes(128) == 1024 + 2 * 32768 + 4 * 16384 \
        + 4 * 256 + 40
    assert tfa.backward_smem_bytes(256) == 1024 + 2 * 65536 + 2 * 32768 \
        + 2 * 256 + 24
    # dQ: Q, dO 32 KB each; 2 stages of K, V 16 KB each
    assert tfa.backward_smem_bytes(128, dq=True) == 1024 + 2 * 32768 \
        + 4 * 16384 + 72
    assert tfa.backward_smem_bytes(256, dq=True) == 1024 + 2 * 65536 \
        + 2 * 32768 + 40


def test_backward_wrapper_refuses_cpu_tensors():
    q = torch.randn(1, 8, 2, 32).bfloat16()
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_bf16(q, q, q, q, lse, q)
    x = torch.randn(2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm_bwd(x, torch.zeros(32), x)


def _packed(B, S, H, KV, hd, dtype=torch.bfloat16):
    """q, k, v as views of one (B, S, H + 2 KV, hd) tensor."""
    qkv = torch.empty((B, S, H + 2 * KV, hd), dtype=dtype)
    return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]


def _route(q, k, v):
    return tfa.kernel_route(q.dtype, q.shape, q.stride(), q.data_ptr(),
                            k.shape, ((k.stride(), k.data_ptr()),
                                      (v.stride(), v.data_ptr())))


def _views(dtype, B=2, S=40, H=8, KV=2, hd=64):
    return tuple(torch.empty((B, S, n, hd), dtype=dtype) for n in (H, KV, KV))


def test_kernel_route_picks_the_kernel_by_dtype():
    assert _route(*_views(torch.bfloat16)) == "bf16"
    assert _route(*_views(torch.float32)) == "fp32"
    assert _route(*_packed(2, 33, 8, 2, 128)) == "bf16"
    # a padded head stride TMA cannot step over is still fine in fp32
    pad = torch.empty((1, 16, 4, 68))[..., :64]
    assert _route(pad, pad, pad) == "fp32"
    with pytest.raises(TypeError, match="float16"):
        _route(*_views(torch.float16))


@pytest.mark.parametrize("make, why", [
    # head stride 68 bf16 = 136 bytes: not a multiple of 16
    (lambda: torch.empty((1, 16, 4, 68), dtype=torch.bfloat16)[..., :64],
     "stride 68 of dim H is 136 bytes"),
    # base 2 bytes past an aligned one
    (lambda: torch.empty(1 + 16 * 4 * 64, dtype=torch.bfloat16)[1:]
     .view(1, 16, 4, 64), "not 16-byte aligned"),
    (lambda: torch.empty((1, 16, 64, 4), dtype=torch.bfloat16)
     .transpose(2, 3), "contiguous last dim"),
])
def test_kernel_route_refuses_what_tma_cannot_read(make, why):
    bad = make()
    good = torch.empty(bad.shape, dtype=torch.bfloat16)
    for q, k, v in ((bad, good, good), (good, good, bad)):
        with pytest.raises(ValueError, match=why):
            _route(q, k, v)


def test_kernel_route_checks_shapes():
    q, k, v = _views(torch.bfloat16, H=6, KV=4)
    with pytest.raises(ValueError, match="multiple of KV"):
        _route(q, k, v)
    q, k, v = _views(torch.bfloat16, hd=96)
    with pytest.raises(ValueError, match="head_dim 96"):
        _route(q, k, v)


def test_tma_checks_are_pure_functions_of_the_layout():
    # size-1 dims are never stepped over: any stride there is fine
    assert tfa.tma_strides((1, 1, 1, 64), (7, 3, 5, 1)) == (64, 64, 64)
    assert tfa.tma_strides((2, 9, 4, 32), (1152, 128, 32, 1)) == \
        (1152, 128, 32)
    assert tfa.tma_problem((1, 1, 1, 64), (7, 3, 5, 1), 0x1000) is None
    assert tfa.tma_problem((2, 9, 4, 32), (1152, 128, 32, 1), 0x1000) is None
    assert "dim S" in tfa.tma_problem((2, 9, 4, 32), (1184, 132, 32, 1), 0)
    assert "aligned" in tfa.tma_problem((2, 9, 4, 32), (1152, 128, 32, 1), 8)
    assert "2**40" in tfa.tma_problem((2, 9, 4, 32), (2**40, 128, 32, 1), 0)


# --- build: a library's name follows every file it is compiled from -----

def test_library_name_hashes_included_headers(tmp_path):
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n#include <cuda.h>\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// one\n")
    assert [p.name for p in build.inputs(tmp_path / "a.cu")] == \
        ["a.cu", "g.cuh", "h.cuh"]
    before = build.library_path(tmp_path / "a.cu")
    (tmp_path / "g.cuh").write_text("// two\n")
    assert build.library_path(tmp_path / "a.cu") != before


def test_every_source_builds_from_the_package():
    names = {p.name for n in build.SOURCES
             for p in build.inputs(build.CSRC / f"{n}.cu")}
    assert names == {"adamw.cu", "flash_attention.cu",
                     "flash_attention_sm90.cu",
                     "flash_attention_bwd.cu", "flash_attention_bwd_sm90.cu",
                     "rmsnorm.cu", "sm90_ptx.cuh", "tf32x3.cuh"}


def test_kernel_times_needs_a_card():
    """``python -m repro_torch.launch.kernel_times`` times the card's K2,
    both routes, and refuses to run without one."""
    from repro_torch.launch import kernel_times
    assert all(hd in tfa.SUPPORTED_HEAD_DIMS and H % KV == 0
               for _, _, H, KV, hd, _ in kernel_times.SHAPES
               + kernel_times.FP32_SHAPES)
    assert all(hd in tfa.SUPPORTED_HEAD_DIMS and H % KV == 0
               for _, _, H, KV, hd in kernel_times.BWD_SHAPES
               + kernel_times.FP32_BWD_SHAPES)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_times.main(["x"])


def test_ref_names_the_plain_versions():
    assert tref.rmsnorm_ref is trn.rmsnorm_plain
    assert tref.flash_attention_ref is tfa.flash_attention_plain


# --- dispatch: no fallback, launches counted only for the kernel --------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    """Forward and backward: CPU tensors under autograd take the plain
    versions (autograd through them) and launch nothing."""
    ops.reset_launch_counts()
    x = torch.randn(3, 64, requires_grad=True)
    ops.rmsnorm(x, torch.zeros(64)).sum().backward()
    q = torch.randn(1, 16, 2, 32, requires_grad=True)
    ops.flash_attention(q, q, q).sum().backward()
    assert x.grad is not None and q.grad is not None
    assert ops.launch_counts() == {"rmsnorm": 0, "rmsnorm_rows": 0,
                                   "rmsnorm_ring": 0, "rmsnorm_bwd": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bf16": 0,
                                   "flash_attention_fp32": 0,
                                   "flash_attention_bwd_bf16": 0,
                                   "flash_attention_bwd_fp32": 0,
                                   "adamw_sumsq": 0, "adamw_update": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.randn(2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm(x, torch.zeros(32))
    q = torch.randn(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)


def test_ops_refuse_other_devices():
    x = torch.empty(2, 32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.rmsnorm(x, torch.empty(32, device="meta"))
