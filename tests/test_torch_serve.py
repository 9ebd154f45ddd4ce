"""The port's dense serving path (repro_torch) against the JAX package.

The JAX model is initialised, its parameter tree handed over as numpy
arrays and converted into the port's model, and both run the same tokens
in float32 on the CPU: ``prefill_logits`` (including one case past JAX's
``CHUNK_THRESHOLD``, where JAX switches to chunked attention),
``sequential_prefill`` and greedy ``decode_tokens``. yi-9b reduced covers
the global-attention llama layout; gemma3-12b reduced covers the 5:1
local:global pattern, ring-buffer local caches (S > window, so they wrap)
and the plain path of windowed layers.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.models.layers import CHUNK_THRESHOLD
from repro.train import serve as jserve
from repro_torch.kernels import ops
from repro_torch.models import convert
from repro_torch.models import registry as treg
from repro_torch.models.config import ModelConfig
from repro_torch.train import serve as tserve
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["yi-9b", "gemma3-12b"]
B, S, MAX_SEQ, N_DECODE = 2, 32, 48, 8
# float32 on both sides; the two frameworks only round in other places
TOL = 2e-4


class Pair:
    """A reduced config run by both packages on the same weights."""

    def __init__(self, arch, perturb=None, **overrides):
        self.jcfg = jreg.load_config(arch).reduced(**overrides)
        self.tcfg = treg.load_config(arch).reduced(**overrides)
        self.jparams = jreg.init_params(self.jcfg, jax.random.PRNGKey(0))
        if perturb is not None:
            self.jparams = perturb(self.jparams)
        self.model = convert.from_jax(jax.tree.map(np.asarray, self.jparams),
                                      self.tcfg, device="cpu")
        toks = np.random.default_rng(7).integers(0, self.jcfg.vocab, (B, S))
        self.jtokens = jnp.asarray(toks, jnp.int32)
        self.ttokens = torch.from_numpy(toks)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


def test_configs_match_jax():
    for arch in ARCHS + ["gpt"]:
        j, t = jreg.load_config(arch), treg.load_config(arch)
        for cj, ct in ((j, t), (j.reduced(), t.reduced())):
            assert {k: getattr(ct, k) for k in ct.__dataclass_fields__} == \
                {k: getattr(cj, k) for k in cj.__dataclass_fields__}
            assert ct.torch_dtype == getattr(torch, cj.jdtype.name)
            assert treg.n_params(ct) == jreg.n_params(cj)
    assert treg.n_params(treg.load_config("yi-9b")) == 8_829_407_232


def test_prefill_matches_jax(pair):
    want = jserve.prefill_logits(pair.jparams, pair.jcfg,
                                 {"tokens": pair.jtokens})
    got = tserve.prefill_logits(pair.model, {"tokens": pair.ttokens})
    assert got.shape == (B, S, pair.tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_sequential_prefill_matches_jax(pair):
    _, want = jserve.sequential_prefill(pair.jparams, pair.jcfg, pair.jtokens,
                                        max_seq=MAX_SEQ)
    _, got = tserve.sequential_prefill(pair.model, pair.ttokens,
                                       max_seq=MAX_SEQ)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_decode_tokens_match_jax(pair):
    jcache, jlogits = jserve.sequential_prefill(
        pair.jparams, pair.jcfg, pair.jtokens, max_seq=MAX_SEQ)
    last = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
    _, want = jserve.decode_tokens(pair.jparams, pair.jcfg, jcache, last, S,
                                   N_DECODE)
    tcache, _ = tserve.sequential_prefill(pair.model, pair.ttokens,
                                          max_seq=MAX_SEQ)
    _, got = tserve.decode_tokens(pair.model, tcache,
                                  torch.from_numpy(np.array(last)).long(),
                                  S, N_DECODE)
    assert got.shape == (B, N_DECODE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_long_prefill_crosses_jax_chunked_branch(arch):
    """B=1 past CHUNK_THRESHOLD: JAX runs gqa_attend_chunked (with a ragged
    last chunk); the port runs its flash-attention path for global layers
    and its own gqa_attend_chunked for gemma3's windowed ones."""
    p = Pair(arch)
    s_long = CHUNK_THRESHOLD + 52
    toks = np.random.default_rng(8).integers(0, p.jcfg.vocab, (1, s_long))
    want = jserve.prefill_logits(p.jparams, p.jcfg,
                                 {"tokens": jnp.asarray(toks, jnp.int32)})
    got = tserve.prefill_logits(p.model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _perturbed(params):
    """Non-zero biases and norm scales (both initialise to zero), so that
    a dropped bias or (1 + scale) would show."""
    rng = np.random.default_rng(9)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bq", "bv", "bo", "b1", "b2", "pre_attn", "pre_mlp",
                       "final_norm"):
                out[k] = jnp.asarray(rng.normal(size=v.shape) * 0.1, v.dtype)
            else:
                out[k] = v
        return out

    return walk(params)


def test_bias_softcap_variant_matches_jax():
    """yi-9b reduced with use_bias and logit_softcap: the gelu MLP, the
    projection biases, softcapped attention on the plain path, and the
    final-logit softcap of forward (which decode_step does not apply, in
    both packages)."""
    p = Pair("yi-9b", perturb=_perturbed, use_bias=True, logit_softcap=20.0)
    want = jserve.prefill_logits(p.jparams, p.jcfg, {"tokens": p.jtokens})
    got = tserve.prefill_logits(p.model, {"tokens": p.ttokens})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    _, want = jserve.sequential_prefill(p.jparams, p.jcfg, p.jtokens,
                                        max_seq=MAX_SEQ)
    _, got = tserve.sequential_prefill(p.model, p.ttokens, max_seq=MAX_SEQ)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_converter_keeps_jax_layer_order():
    """Layer g*P + i comes from blocks/p{i}[g] (gemma3: P=6, 2 reps)."""
    cfg = treg.load_config("gemma3-12b").reduced()
    P = len(cfg.pattern)
    jcfg = jreg.load_config("gemma3-12b").reduced()
    params = jax.tree.map(np.asarray,
                          jreg.init_params(jcfg, jax.random.PRNGKey(3)))
    model = convert.from_jax(params, cfg, device="cpu")
    for layer, blk in enumerate(model.blocks):
        g, i = divmod(layer, P)
        np.testing.assert_array_equal(
            blk.attn.wq.numpy(), params["blocks"][f"p{i}"]["attn"]["wq"][g])
    assert model.blocks[0].attn.wq.shape == (cfg.d_model, cfg.n_heads * cfg.hd)


def test_prefill_goes_through_the_kernel_dispatch(monkeypatch):
    """Every layer's norms and attention reach ops, windowed layers too
    (gemma3: 10 local + 2 global layers)."""
    cfg = treg.load_config("gemma3-12b").reduced()
    model = treg.init_params(cfg, seed=0, device="cpu")
    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ops, "rmsnorm", counted("rmsnorm", ops.rmsnorm))
    monkeypatch.setattr(ops, "flash_attention",
                        counted("flash_attention", ops.flash_attention))
    tserve.prefill_logits(model, {"tokens": torch.zeros(1, 20,
                                                        dtype=torch.long)})
    assert calls == {"rmsnorm": 2 * cfg.n_layers + 1,
                     "flash_attention": cfg.n_layers}


def test_init_params_is_seeded_and_follows_fan_in():
    cfg = treg.load_config("yi-9b").reduced()
    a = treg.init_params(cfg, seed=5, device="cpu")
    b = treg.init_params(cfg, seed=5, device="cpu")
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    assert torch.count_nonzero(a.final_norm) == 0      # norm scales start at 0
    std = a.embed.std().item()                          # fan_in = vocab
    assert abs(std * np.sqrt(cfg.vocab) - 1.0) < 0.05


def test_sampled_decode_uses_the_generator():
    cfg = treg.load_config("yi-9b").reduced()
    model = treg.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros(2, 4, dtype=torch.long)

    def sample(seed):
        cache, _ = tserve.sequential_prefill(model, toks, max_seq=12)
        gen = torch.Generator().manual_seed(seed)
        return tserve.decode_tokens(model, cache, toks[:, -1:], 4, 6,
                                    temperature=1.0, generator=gen)[1]

    a, b = sample(11), sample(11)
    assert torch.equal(a, b)
    assert a.shape == (2, 6) and int(a.min()) >= 0 and int(a.max()) < cfg.vocab


def test_entry_points_without_device_raise_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.load_config("yi-9b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        treg.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_jax({}, cfg)


def test_explicit_positions_take_rope_and_the_plain_path(monkeypatch):
    """Positions 3, 5, 7, ...: RoPE rotates by them (a stride of 2 doubles
    every relative distance, which a shift alone would not change) and the
    mask reads them, so the logits are JAX's with the same positions, and no
    layer reaches the attention kernel (it computes positions 0..S-1
    only)."""
    p = Pair("yi-9b")
    pos = 3 + 2 * np.arange(S)
    want = jserve.prefill_logits(p.jparams, p.jcfg,
                                 {"tokens": p.jtokens,
                                  "positions": jnp.asarray(pos)})
    default = tserve.prefill_logits(p.model, {"tokens": p.ttokens})
    calls = []
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1))
    got = tserve.prefill_logits(p.model, {"tokens": p.ttokens,
                                          "positions": torch.from_numpy(pos)})
    assert calls == []
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert not torch.allclose(got, default, atol=1e-3)


def test_every_family_resolves_and_unknown_ones_raise():
    module = {"dense": "dense", "vlm": "dense", "moe": "moe", "ssm": "ssm",
              "hybrid": "hybrid", "audio": "encdec"}
    for arch in jreg.ARCH_IDS + ["gpt"]:
        cfg = treg.load_config(arch)
        assert treg.family_module(cfg).__name__ == \
            f"repro_torch.models.{module[cfg.family]}", arch
    moe = treg.init_params(treg.load_config("mixtral-8x7b").reduced(),
                           device="cpu")
    assert len(moe.blocks) == moe.cfg.n_layers
    odd = ModelConfig(name="m", family="retrieval", n_layers=2, d_model=64,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab=32)
    with pytest.raises(ValueError, match="unknown model family"):
        treg.init_params(odd, device="cpu")
    with pytest.raises(ModuleNotFoundError):
        treg.load_config("llama-7b")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert len(mods) >= 14, mods\n"
        "for fam in ('dense', 'moe', 'ssm', 'hybrid', 'encdec'):\n"
        "    assert f'repro_torch.models.{fam}' in mods, fam\n"
        "for arch in ('command_r_35b', 'gemma3_27b', 'kimi_k2_1t_a32b',"
        " 'mamba2_1_3b', 'mixtral_8x7b', 'qwen2_vl_2b', 'recurrentgemma_2b',"
        " 'whisper_medium'):\n"
        "    assert f'repro_torch.configs.{arch}' in mods, arch\n"
        "for m in ('mesh', 'inputs', 'dryrun'):\n"
        "    assert f'repro_torch.launch.{m}' in mods, m\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'an import started a process group'\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ,
                                           PYTHONPATH=os.path.join(ROOT, "src")),
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
