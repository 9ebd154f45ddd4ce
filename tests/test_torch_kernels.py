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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref as tref
from repro_torch.kernels import rmsnorm as trn

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
                                   (3, 5, 8, 128)])
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


def test_ref_names_the_plain_versions():
    assert tref.rmsnorm_ref is trn.rmsnorm_plain
    assert tref.flash_attention_ref is tfa.flash_attention_plain


# --- dispatch: no fallback, launches counted only for the kernel --------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(3, 64)
    ops.rmsnorm(x, torch.zeros(64))
    q = torch.randn(1, 16, 2, 32)
    ops.flash_attention(q, q, q)
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0}


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
