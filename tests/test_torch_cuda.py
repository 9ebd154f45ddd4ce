"""The port's kernels on the card, against their plain PyTorch versions,
and the verifier's main path (capture, inference, numeric replay) on it.

Every test here is marked ``cuda`` and skips without a GPU. The file
imports neither JAX nor the JAX package, so it also runs on the machine
with the card: ``python -m pytest -q tests/test_torch_cuda.py``.
"""
import copy
import inspect
import json
import os

import pytest
import torch

from repro_torch import api as tapi
from repro_torch.api.replay import max_rel_excess, replay
from repro_torch.api.report import same_up_to_renaming
from repro_torch.core import UnsupportedPrimitive, capture, strict_capture
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


def _norm_inputs(device, rows, D, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, D, generator=g, device=device).to(dtype)
    s = (torch.randn(D, generator=g, device=device) * 0.1).to(dtype)
    return x, s


def _assert_norm_close(got, x, s):
    # the JAX test's tolerances: fp32 rounding, or one bf16 output ulp
    tol = 1e-5 if x.dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), trn.rmsnorm_plain(x, s).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [128, 384, 3840, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 4, 131, 132, 133, 1024, 4097])
def test_rmsnorm_kernel_matches_plain(cuda_device, rows, D, dtype):
    """Rows on both sides of the plans' threshold (132 SMs on an H100)."""
    x, s = _norm_inputs(cuda_device, rows, D, dtype)
    n0 = trn.rmsnorm.launches
    got = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert trn.rmsnorm.launches == n0 + 1
    _assert_norm_close(got, x, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 4, 133, 1024, 4097])
def test_rmsnorm_both_plans_match_plain(cuda_device, rows, dtype):
    """Each plan at any row count, whichever plan() would pick."""
    x, s = _norm_inputs(cuda_device, rows, 4096, dtype, seed=1)
    n_sm = trn.sm_count(x.device.index)
    for p in (trn.rows_plan(rows, 4096, x.element_size()),
              trn.ring_plan(rows, 4096, x.element_size(), n_sm)):
        got = trn.launch(x, s, 1e-6, p)
        torch.cuda.synchronize()
        _assert_norm_close(got, x, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [4, 1024])
def test_rmsnorm_reads_a_row_strided_view_without_a_copy(cuda_device, rows,
                                                         dtype):
    big, s = _norm_inputs(cuda_device, rows, 4096 + 64, dtype, seed=2)
    x, s = big[:, :4096], s[:4096]
    assert trn.as_rows(x).data_ptr() == big.data_ptr()
    assert trn.as_rows(x).stride(0) == 4096 + 64
    got = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    _assert_norm_close(got, x.contiguous(), s)


@pytest.mark.cuda
def test_rmsnorm_refuses_misaligned_views(cuda_device):
    """Nothing falls back to the plain version: the kernel raises."""
    big, s = _norm_inputs(cuda_device, 8, 4096 + 8, torch.bfloat16)
    counts = ops.launch_counts()
    with pytest.raises(ValueError, match="aligned base"):
        ops.rmsnorm(big[:, 1:4097], s[:4096])      # base 2 bytes off
    with pytest.raises(ValueError, match="row stride"):
        odd = torch.empty(8, 4100, dtype=torch.bfloat16, device=cuda_device)
        ops.rmsnorm(odd[:, :4096], s[:4096])       # 8200-byte rows
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        ops.rmsnorm(big[:, :4092], s[:4092])       # 8184-byte rows
    assert ops.launch_counts() == counts


@pytest.mark.cuda
def test_rmsnorm_launch_counters_per_plan(cuda_device):
    ops.reset_launch_counts()
    n_sm = trn.sm_count(torch.cuda.current_device())
    calls = {4: 3, 132: 1, 133: 2, 1024: 1, 4096: 2}
    want = {"rows": 0, "ring": 0}
    for rows, n in calls.items():
        x, s = _norm_inputs(cuda_device, rows, 4096, torch.bfloat16)
        for _ in range(n):
            ops.rmsnorm(x, s)
        want[trn.plan(rows, 4096, torch.bfloat16, n_sm).name] += n
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert want["rows"] and want["ring"]
    assert (counts["rmsnorm"], counts["rmsnorm_rows"],
            counts["rmsnorm_ring"]) == (9, want["rows"], want["ring"])
    assert dict(trn.rmsnorm.row_launches) == calls


def _qkv(device, B, S, H, KV, hd, dtype, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(B, S, n, hd, generator=g, device=device).to(dtype)
                 for n in (H, KV, KV))


def _assert_close(got, q, k, v, causal):
    want = tfa.flash_attention_plain(q, k, v, causal=causal).float()
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    else:
        # the bf16 kernel rounds P to bf16 before P @ V and both sides round
        # the output to bf16 (worst row ~4e-3 in the CPU emulation), so each
        # row is held relative to its own norm
        rel = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
        assert rel.max().item() <= 1e-2


def _launches(dtype):
    return tfa.KERNELS[tfa.ROUTES[dtype]].launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 70, 4, 2, 128), (2, 256, 8, 8, 64),
                                         (1, 130, 4, 1, 32), (1, 96, 2, 1, 256)])
def test_flash_kernel_matches_plain(cuda_device, dtype, causal, B, S, H, KV,
                                    hd):
    q, k, v = _qkv(cuda_device, B, S, H, KV, hd, dtype)
    n0 = _launches(dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _launches(dtype) == n0 + 1
    _assert_close(got, q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 65, 127, 129, 300])
def test_flash_bf16_ragged_lengths(cuda_device, S, hd, causal):
    """No S divides the tiles (128 query rows, 128 or 64 keys)."""
    q, k, v = _qkv(cuda_device, 2, S, 4, 2, hd, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _assert_close(got, q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_flash_bf16_gqa_groups(cuda_device, group, hd, causal):
    q, k, v = _qkv(cuda_device, 1, 200, 8, 8 // group, hd, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _assert_close(got, q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_reads_views_of_a_packed_qkv(cuda_device, dtype, hd):
    """q, k, v as strided views of one (B, S, H + 2 KV, hd) tensor."""
    B, S, H, KV = 2, 150, 8, 2
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn(B, S, H + 2 * KV, hd, generator=g,
                      device=cuda_device).to(dtype)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_close(got, q.contiguous(), k.contiguous(), v.contiguous(), True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_reads_head_major_views(cuda_device, dtype):
    """(B, H, S, hd) tensors seen as (B, S, H, hd): the head stride exceeds
    the sequence stride."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(2, n, 100, 64, generator=g, device=cuda_device)
               .to(dtype).transpose(1, 2) for n in (8, 2, 2))
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_close(got, q.contiguous(), k.contiguous(), v.contiguous(), True)


@pytest.mark.cuda
def test_flash_bf16_refuses_what_tma_cannot_read(cuda_device):
    """A head stride of 68 bf16 (136 bytes) raises; nothing falls back to
    the scalar kernel or the plain version."""
    q = torch.randn(1, 64, 4, 68, device=cuda_device).bfloat16()[..., :64]
    k = torch.randn(1, 64, 2, 64, device=cuda_device).bfloat16()
    counts = ops.launch_counts()
    with pytest.raises(ValueError, match="TMA"):
        ops.flash_attention(q, k, k)
    assert ops.launch_counts() == counts
    # the fp32 route reads any stride with a contiguous last dim
    got = ops.flash_attention(q.float(), k.float(), k.float())
    torch.cuda.synchronize()
    _assert_close(got, q.float().contiguous(), k.float(), k.float(), True)


@pytest.mark.cuda
def test_flash_launch_counters_per_route(cuda_device):
    ops.reset_launch_counts()
    for dtype, n in ((torch.bfloat16, 3), (torch.float32, 2)):
        q, k, v = _qkv(cuda_device, 1, 40, 2, 1, 64, dtype)
        for _ in range(n):
            ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["flash_attention_bf16"], counts["flash_attention_fp32"],
            counts["flash_attention"]) == (3, 2, 5)


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


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "suite_degree2.json")


@pytest.fixture
def no_tf32():
    """The replay holds float32 results to 2e-4; TF32 products would not
    meet it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("case", tapi.list_strategies())
def test_verify_case_on_the_card(cuda_device, no_tf32, case):
    """The clean case at degree 2 against the golden, its first bug as
    registered, and the certificate's numeric replay, all on the card."""
    golden = json.load(open(GOLDEN))[f"{case}@deg2"]
    r = tapi.verify(case, degree=2, device=cuda_device)
    assert (r.verdict, r.ok) == (golden["verdict"], True), r.error
    assert same_up_to_renaming(r.r_o, golden["r_o"])
    entry = tapi.get_strategy(case)
    if entry.bugs:
        b = entry.bugs[0]
        rb = tapi.verify(case, degree=2, bug=b.name, device=cuda_device)
        assert rb.ok and rb.expected == b.expected, rb.error
    got, want = replay(tapi.build_spec(case, degree=2, device=cuda_device),
                       cuda_device)
    assert all(v.device.type == "cuda" for v in got.values())
    assert max_rel_excess(got, want) <= 1.0


def _unsupported(x):
    return torch.cumprod(x, 0)


@pytest.mark.cuda
def test_unsupported_op_names_the_users_line_on_the_card(cuda_device):
    """The strict frontend's ``file:line`` comes from a private torch.fx
    hook; this holds it on the card's own torch build."""
    line = inspect.getsourcelines(_unsupported)[1] + 1
    with pytest.raises(UnsupportedPrimitive) as exc:
        with strict_capture():
            capture(_unsupported, [((4,), torch.float32)], ["x"],
                    device=cuda_device)
    assert exc.value.primitive == "aten.cumprod"
    assert exc.value.source.startswith(f"{os.path.abspath(__file__)}:{line}")
    assert f"test_torch_cuda.py:{line} (_unsupported)" in str(exc.value)


@pytest.mark.cuda
def test_pooled_suite_after_cuda_in_the_parent(cuda_device, no_tf32):
    """Spawned workers after the parent made its CUDA context (a forked
    one could not use the card): the pooled suite gives the in-process
    summaries, every worker traced on the card and launched no kernel."""
    from repro_torch.obs import trace as obs_trace
    (torch.ones(1, device=cuda_device) * 2).sum().item()
    cases, degrees = ["tp_layer", "sp_rope", "ep_moe"], (2,)
    inline = tapi.Suite(cases=cases, degrees=degrees, include_bugs=True) \
        .run(workers=0, device="cuda")
    tracer = obs_trace.start("main")
    try:
        with tapi.Suite(cases=cases, degrees=degrees,
                        include_bugs=True) as s:
            pooled = s.run(workers=2, timeout_s=300.0, device="cuda")
    finally:
        obs_trace.stop()
    assert pooled.stable_summary() == inline.stable_summary()
    assert not any((r.runtime or {}).get("degraded_reason") for r in pooled)
    spans = [e for e in tracer.events if e.get("name") == "task"]
    assert len(spans) == len(pooled)
    for e in spans:
        assert e["args"]["device"] == "cuda"
        assert e["args"]["cuda_initialized"] is True
        assert not any(e["args"]["launches"].values())


@pytest.mark.cuda
def test_fn_cli_on_the_card(cuda_device):
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    for target, rc in (("make_task", 0), ("make_buggy_task", 1)):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.verify", "--fn",
             f"repro_torch.verify_your_own_fn:{target}", "--json"],
            capture_output=True, text=True, timeout=300, env=env)
        assert r.returncode == rc, r.stderr
        rep = json.loads(r.stdout)["report"]
        if rc == 0:
            assert rep["verdict"] == "certificate"
            assert rep["r_o"] == {"t2": "t3@tp0"}
        else:
            assert rep["verdict"] == "refinement_error"
            assert rep["localization"]["op_name"] == "output-filter"
