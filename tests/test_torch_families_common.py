"""Shared set-up of the port's family tests: one reduced config run by both
packages on the same weights and the same seeded numpy inputs.

The JAX model is initialised, its parameter tree handed over as numpy
arrays and converted into the port's model (``convert.from_jax``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import registry as jreg
from repro.train import serve as jserve
from repro_torch.models import convert
from repro_torch.models import registry as treg
from repro_torch.train import serve as tserve

# one architecture per family module (as tests/test_serve_numeric.py)
FAMILY_ARCHS = {
    "dense": "gemma3-12b", "moe": "mixtral-8x7b", "ssm": "mamba2-1.3b",
    "hybrid": "recurrentgemma-2b", "vlm": "qwen2-vl-2b",
    "audio": "whisper-medium",
}
ALL_ARCHS = ["gpt"] + jreg.ARCH_IDS
B, S, MAX_SEQ, N_DECODE = 2, 32, 48, 8
# float32 on both sides; the two frameworks only round in other places
TOL = 2e-4


class Pair:
    """A reduced config run by both packages on the same weights."""

    def __init__(self, arch, seed=0, **overrides):
        self.jcfg = jreg.load_config(arch).reduced(**overrides)
        self.tcfg = treg.load_config(arch).reduced(**overrides)
        self.jparams = jreg.init_params(self.jcfg, jax.random.PRNGKey(seed))
        self.model = convert.from_jax(jax.tree.map(np.asarray, self.jparams),
                                      self.tcfg, device="cpu")
        rng = np.random.default_rng(7)
        self.tokens = rng.integers(0, self.jcfg.vocab, (B, S))
        self.frames = self.patches = None
        if self.tcfg.family == "audio":
            self.frames = rng.normal(
                size=(B, self.tcfg.encoder_frames, self.tcfg.d_model)
            ).astype(np.float32)
        if self.tcfg.family == "vlm":
            self.patches = rng.normal(
                size=(B, self.tcfg.vision_tokens, self.tcfg.d_model)
            ).astype(np.float32)

    @property
    def family(self):
        return self.tcfg.family

    def batches(self, positions=None, patches=True):
        """The same batch for JAX and for the port."""
        j = {"tokens": jnp.asarray(self.tokens, jnp.int32)}
        t = {"tokens": torch.from_numpy(self.tokens)}
        extra = {"frames": self.frames, "positions": positions,
                 "patch_embeds": self.patches if patches else None}
        for k, v in extra.items():
            if v is not None:
                j[k] = jnp.asarray(v)
                t[k] = torch.from_numpy(np.asarray(v))
        return j, t

    def prefill(self, **kw):
        jb, tb = self.batches(**kw)
        return (np.asarray(jserve.prefill_logits(self.jparams, self.jcfg, jb)),
                tserve.prefill_logits(self.model, tb))

    def sequential(self, tokens=None, max_seq=MAX_SEQ):
        """(JAX (cache, logits), port (cache, logits)) of sequential_prefill
        over ``tokens`` (the pair's own by default)."""
        toks = self.tokens if tokens is None else tokens
        jf = None if self.frames is None else jnp.asarray(self.frames)
        tf = None if self.frames is None else torch.from_numpy(self.frames)
        return (jserve.sequential_prefill(self.jparams, self.jcfg,
                                          jnp.asarray(toks, jnp.int32),
                                          max_seq=max_seq, frames=jf),
                tserve.sequential_prefill(self.model, torch.from_numpy(toks),
                                          max_seq=max_seq, frames=tf))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rel_rms(got, want):
    got, want = f32(got), f32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
