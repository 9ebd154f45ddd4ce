"""The port's model substrate (repro_torch.models) beside the JAX package's:
configs, parameter counts and logical axes of every config, the leaf
initialiser, the MoE dispatch's capacity drop, the kernel routing of
every family, and K2's plain version at kimi-k2's head dim 112.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.train import serve as tserve

from test_torch_families_common import ALL_ARCHS, FAMILY_ARCHS, f32
from torch_parity import one_thread_module  # noqa: F401 (one thread)

# --- configs, counts, logical axes ---------------------------------------


def test_arch_ids_match_jax():
    assert treg.ARCH_IDS == jreg.ARCH_IDS


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_counts_and_logical_axes_match_jax(arch):
    j, t = jreg.load_config(arch), treg.load_config(arch)
    for cj, ct in ((j, t), (j.reduced(), t.reduced()),
                   (j.reduced(dtype="bfloat16"), t.reduced(dtype="bfloat16"))):
        assert {k: getattr(ct, k) for k in ct.__dataclass_fields__} == \
            {k: getattr(cj, k) for k in cj.__dataclass_fields__}
        assert ct.torch_dtype == getattr(torch, cj.jdtype.name)
        assert treg.n_params(ct) == jreg.n_params(cj)
        assert treg.n_active_params(ct) == jreg.n_active_params(cj)
        assert treg.logical_axes(ct) == jreg.logical_axes(cj)


def test_published_sizes():
    counts = {a: (treg.n_params(treg.load_config(a)),
                  treg.n_active_params(treg.load_config(a)))
              for a in ("mixtral-8x7b", "kimi-k2-1t-a32b", "whisper-medium",
                        "yi-9b")}
    assert counts == {
        "mixtral-8x7b": (46_702_792_704, 12_879_925_248),
        "kimi-k2-1t-a32b": (1_041_166_988_288, 31_061_144_576),
        "whisper-medium": (758_344_704, 758_344_704),
        "yi-9b": (8_829_407_232, 8_829_407_232),
    }


# --- the leaf initialiser ------------------------------------------------


def test_init_gives_ones_for_scale_minus_one_and_is_seeded():
    """A_log and D (mamba2), lambda_p (recurrentgemma) start at ones, as
    JAX's init_tree gives them; norm scales and biases at zeros."""
    for arch, leaves in (("mamba2-1.3b", ("A_log", "D")),
                         ("recurrentgemma-2b", ("lambda_p",))):
        cfg = treg.load_config(arch).reduced()
        a = treg.init_params(cfg, seed=5, device="cpu")
        b = treg.init_params(cfg, seed=5, device="cpu")
        for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(pa, pb), n
            if n.split(".")[-1] in leaves:
                assert torch.equal(pa, torch.ones_like(pa)), n
            if n.endswith(("norm", "conv_b", "dt_bias")):
                assert torch.count_nonzero(pa) == 0, n
        jp = jreg.init_params(jreg.load_config(arch).reduced(),
                              jax.random.PRNGKey(0))
        for leaf in leaves:
            blk = jp["blocks"] if arch == "mamba2-1.3b" \
                else jp["blocks"]["p0"]["rglru"]
            np.testing.assert_array_equal(np.asarray(blk[leaf]), 1.0)


def test_large_leaves_are_drawn_in_slices(monkeypatch):
    """A leaf above DRAW_ELEMENTS is drawn a slice of leading rows at a time:
    no float32 draw of the whole leaf, the same std, every row filled."""
    monkeypatch.setattr(tlayers, "DRAW_ELEMENTS", 4096)
    sizes = []
    randn = torch.randn

    def spy(*a, **k):
        out = randn(*a, **k)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    lf = tlayers.Leaf((48, 64, 32), ("experts", "embed", "ff"))
    t = torch.empty(lf.shape, dtype=torch.bfloat16)
    tlayers.init_leaf_(t, lf, torch.Generator().manual_seed(0))
    assert max(sizes) <= 4096 and sum(sizes) == t.numel()
    assert len(sizes) == 48 // (4096 // (64 * 32))
    assert torch.count_nonzero(t.float().abs().amax(dim=(1, 2))) == 48
    assert abs(t.float().std().item() * np.sqrt(64) - 1.0) < 0.05
    # a leaf at or under the limit is one draw, as before
    sizes.clear()
    small = torch.empty((64, 64))
    tlayers.init_leaf_(small, tlayers.Leaf((64, 64), (None, None)),
                       torch.Generator().manual_seed(0))
    assert sizes == [4096]


# --- MoE: the capacity drop ----------------------------------------------


def _one_hot_experts(cfg, rng):
    """Expert weights whose output for expert e lies in dimension e only,
    so a token's output says which of its experts were kept; a router that
    sends most tokens to expert 0 through dimension D-1 of x."""
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    # std 1/sqrt(fan_in), the model's own init rule
    wd = np.zeros((E, Fe, D), np.float32)
    for e in range(E):
        wd[e, :, e] = rng.normal(size=Fe) / np.sqrt(Fe)
    router = rng.normal(size=(D, E)).astype(np.float32) * 0.1
    router[D - 1, 0] = 3.0
    return {"router": router,
            "wg": rng.normal(size=(E, D, Fe)).astype(np.float32) / np.sqrt(D),
            "wu": rng.normal(size=(E, D, Fe)).astype(np.float32) / np.sqrt(D),
            "wd": wd}


def test_moe_capacity_drop_matches_jax():
    """64 tokens, top-2 of 4 experts, capacity 40: expert 0 is chosen by
    (nearly) every token, so rows certainly drop. The dropped (token,
    expert) pairs read off both outputs are the same set, the port's own
    dispatch names that set, and the outputs agree to 1e-6."""
    cfg = treg.load_config("mixtral-8x7b").reduced()
    jcfg = jreg.load_config("mixtral-8x7b").reduced()
    rng = np.random.default_rng(11)
    p = _one_hot_experts(cfg, rng)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    x[..., -1] = 2.0 + rng.random(size=(2, 32))
    logits = x.reshape(-1, cfg.d_model) @ p["router"]
    assert all(len(set(r)) == cfg.n_experts for r in logits.round(6))
    wy, waux = jmoe.moe_mlp({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                            jnp.asarray(x))
    tp = torch.nn.Module()
    for k, v in p.items():
        setattr(tp, k, torch.nn.Parameter(torch.from_numpy(v),
                                          requires_grad=False))
    ty, taux = tmoe.moe_mlp(tp, cfg, torch.from_numpy(x))
    wy, ty = np.asarray(wy).reshape(-1, cfg.d_model), \
        ty.numpy().reshape(-1, cfg.d_model)
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]

    def dropped(y):
        return {(t, int(e)) for t in range(len(top)) for e in top[t]
                if y[t, e] == 0.0}

    r = tmoe.route(tp.router, cfg, torch.from_numpy(x).reshape(-1,
                                                               cfg.d_model))
    mine = {(int(t), int(e)) for t, e, k in zip(r["st"], r["se"], r["keep"])
            if not k}
    assert r["C"] == 40 and len(mine) >= 20
    assert dropped(wy) == dropped(ty) == mine
    np.testing.assert_allclose(ty, wy, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(taux.item(), float(waux), rtol=1e-6)


def test_moe_top_k_breaks_ties_toward_the_lower_expert():
    """Equal router logits: jax.lax.top_k keeps the lower expert index
    first, and so does the port; the gates split evenly."""
    cfg = treg.load_config("mixtral-8x7b").reduced()
    router = torch.zeros(cfg.d_model, cfg.n_experts)
    r = tmoe.route(router, cfg, torch.ones(3, cfg.d_model))
    assert r["se"].tolist() == [0, 0, 0, 1, 1, 1]
    assert torch.equal(r["sg"], torch.full((6,), 0.5))
    _, idx = jax.lax.top_k(jnp.zeros((3, cfg.n_experts)), cfg.top_k)
    assert np.asarray(idx).tolist() == [[0, 1]] * 3


def test_moe_decode_step_can_drop_rows_too():
    """Decode runs moe_mlp with T = B: 8 tokens top-2 of 4 give capacity 5.
    Every token picks expert 0 and, on a tie of the rest, expert 1, so
    each of the two drops 3 of its 8 rows."""
    cfg = treg.load_config("mixtral-8x7b").reduced()
    assert tmoe.capacity(cfg, 8) == 5
    router = torch.zeros(cfg.d_model, cfg.n_experts)
    router[0, 0] = 10.0
    x = torch.zeros(8, cfg.d_model)
    x[:, 0] = 1.0
    r = tmoe.route(router, cfg, x)
    assert r["se"][~r["keep"]].tolist() == [0, 0, 0, 1, 1, 1]
    assert r["st"][~r["keep"]].tolist() == [5, 6, 7, 5, 6, 7]


# --- kernel routing -------------------------------------------------------


def _dispatch_counts(monkeypatch, cfg, batch, decode=False):
    calls = {"rmsnorm": 0, "flash_attention": []}

    def norm(*a, **k):
        calls["rmsnorm"] += 1
        return norm.fn(*a, **k)

    def attn(q, k, v, *, causal=True, window=0):
        calls["flash_attention"].append((causal, window))
        return attn.fn(q, k, v, causal=causal, window=window)

    norm.fn, attn.fn = ops.rmsnorm, ops.flash_attention
    monkeypatch.setattr(ops, "rmsnorm", norm)
    monkeypatch.setattr(ops, "flash_attention", attn)
    model = treg.init_params(cfg, seed=0, device="cpu")
    if decode:
        cache = treg.init_cache(model, 1, 8)
        treg.decode_step(model, cache, batch["tokens"][:, :1], 0)
    else:
        tserve.prefill_logits(model, batch)
    return calls


@pytest.mark.parametrize("arch", sorted(set(FAMILY_ARCHS.values()))
                         + ["kimi-k2-1t-a32b"])
@pytest.mark.parametrize("positions", [False, True])
def test_which_attention_reaches_the_kernel(monkeypatch, arch, positions):
    """K2 takes a layer with no softcap, no kv_override and default
    positions, causal or not, whatever its window: every attention layer of
    gemma3 (its local ones with their window), mixtral (windowed),
    recurrentgemma's local layers, kimi-k2 and qwen2-vl, whisper's encoder
    (causal=False) and decoder self-attention (causal=True), not its
    cross-attention; nothing of mamba2. With explicit positions every layer
    keeps the plain path. K1 takes every RMSNorm: 2 a layer + 1 (mamba2's
    norm and out_norm included), and whisper's 3 a decoder layer + 2 an
    encoder layer + 2."""
    cfg = treg.load_config(arch).reduced()
    S = 16
    batch = {"tokens": torch.zeros(1, S, dtype=torch.long)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(1, cfg.vision_tokens,
                                            cfg.d_model)
        S += cfg.vision_tokens
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(1, cfg.encoder_frames, cfg.d_model)
    if positions:
        batch["positions"] = torch.arange(S)
    calls = _dispatch_counts(monkeypatch, cfg, batch)
    L = cfg.n_layers
    if cfg.family == "audio":
        norms = 3 * L + 2 * cfg.encoder_layers + 2
        attn = [(False, 0)] * cfg.encoder_layers + [(True, 0)] * L
        if positions:   # the encoder's positions are its own: 0..F-1
            attn = [(False, 0)] * cfg.encoder_layers
    else:
        norms = 2 * L + 1
        roles = [cfg.pattern[i % len(cfg.pattern)] for i in range(L)]
        attn = [] if positions else [
            (True, cfg.window if r == "local" else 0) for r in roles
            if r in ("global", "local")]
    assert calls == {"rmsnorm": norms, "flash_attention": attn}


@pytest.mark.parametrize("arch", sorted(set(FAMILY_ARCHS.values())))
def test_decode_steps_take_no_attention_kernel(monkeypatch, arch):
    cfg = treg.load_config(arch).reduced()
    calls = _dispatch_counts(monkeypatch, cfg,
                             {"tokens": torch.zeros(1, 1, dtype=torch.long)},
                             decode=True)
    assert calls["flash_attention"] == []
    assert calls["rmsnorm"] == (3 * cfg.n_layers + 1 if cfg.family == "audio"
                                else 2 * cfg.n_layers + 1)


# --- K2 at kimi-k2's head dim ---------------------------------------------


def test_kernel_route_takes_head_dim_112_in_both_dtypes():
    assert 112 in tfa.SUPPORTED_HEAD_DIMS
    for dtype, route in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        q = torch.empty((1, 40, 8, 112), dtype=dtype)
        k = torch.empty((1, 40, 1, 112), dtype=dtype)
        assert tfa.kernel_route(dtype, q.shape, q.stride(), q.data_ptr(),
                                k.shape, ((k.stride(), k.data_ptr()),
                                          (k.stride(), k.data_ptr()))) == route
    # 112 bf16 = 224 bytes a head: TMA steps over it
    assert tfa.tma_problem((1, 40, 8, 112), (40 * 8 * 112, 8 * 112, 112, 1),
                           0) is None


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_at_head_dim_112_matches_jax_ref(causal, dtype):
    """kimi-k2's head dim, GQA 8 over 1 as its 64 over 8."""
    rng = np.random.default_rng(4)
    qn, kn, vn = (rng.normal(size=(2, 96, n, 112)).astype(np.float32)
                  for n in (8, 1, 1))
    want = jref.flash_attention_ref(
        jnp.asarray(qn, dtype), jnp.repeat(jnp.asarray(kn, dtype), 8, 2),
        jnp.repeat(jnp.asarray(vn, dtype), 8, 2), causal=causal)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = ops.flash_attention(*(torch.tensor(f32(jnp.asarray(a, dtype)))
                                .to(tdt) for a in (qn, kn, vn)),
                              causal=causal)
    assert got.shape == (2, 96, 8, 112) and got.dtype == tdt
    # the JAX kernel test's tolerances (fp32 sum order; bf16 output rounding)
    tol = 2e-4 if dtype == jnp.float32 else 5e-2
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
