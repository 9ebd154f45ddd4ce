"""The port's kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a GPU. The file
imports neither JAX nor the JAX package, so it also runs on the machine
with the card: ``python -m pytest -q tests/test_torch_cuda.py``.
"""
import copy

import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as trn
from repro_torch.models import registry
from repro_torch.train import serve


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(300, 4096, generator=g, device=cuda_device).to(dtype)
    s = (torch.randn(4096, generator=g, device=cuda_device) * 0.1).to(dtype)
    n0 = trn.rmsnorm.launches
    got = ops.rmsnorm(x, s)
    assert trn.rmsnorm.launches == n0 + 1
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), trn.rmsnorm_plain(x, s).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 70, 4, 2, 128), (2, 256, 8, 8, 64),
                                         (1, 130, 4, 1, 32), (1, 96, 2, 1, 256)])
def test_flash_kernel_matches_plain(cuda_device, dtype, causal, B, S, H, KV,
                                    hd):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=g, device=cuda_device).to(dtype)
    n0 = tfa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == n0 + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    else:
        # both round one fp32 result to bf16: about one ulp (2^-8) apart
        # where they differ, so each row is held relative to its own norm
        rel = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
        assert rel.max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-12b"])
def test_reduced_model_on_card_matches_cpu(cuda_device, arch):
    """Same weights, fp32: kernels on the card vs plain versions on the CPU,
    at a ragged S=40."""
    cfg = registry.load_config(arch).reduced()
    cpu = registry.init_params(cfg, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    want = serve.prefill_logits(cpu, {"tokens": toks})
    n0 = trn.rmsnorm.launches
    got = serve.prefill_logits(gpu, {"tokens": toks.to(cuda_device)}).cpu()
    assert trn.rmsnorm.launches == n0 + 2 * cfg.n_layers + 1
    # fp32 both sides (TF32 is off by default); only sum orders differ
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
