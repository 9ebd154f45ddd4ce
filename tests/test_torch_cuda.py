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
import sys
from pathlib import Path

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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


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
                                         (1, 130, 4, 1, 32), (1, 96, 2, 1, 256),
                                         (1, 150, 8, 1, 112)])
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
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 65, 127, 129, 300])
def test_flash_bf16_ragged_lengths(cuda_device, S, hd, causal):
    """No S divides the tiles (128 query rows, 128 or 64 keys)."""
    q, k, v = _qkv(cuda_device, 2, S, 4, 2, hd, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _assert_close(got, q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 256])
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
@pytest.mark.parametrize("hd", [32, 112, 256])
def test_flash_fp32_reads_rows_off_the_16_byte_grain(cuda_device, hd):
    """fp32 q, k, v and dy whose head stride (hd + 2 floats) leaves rows
    off the 16-byte grain: the fp32 route copies them 4 bytes at a time,
    forward and backward, and agrees with the plain versions (2e-4)."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v, dy = (torch.randn(2, 150, n, hd + 2, generator=g,
                               device=cuda_device)[..., :hd]
                   for n in (8, 2, 2, 8))
    assert not tfa.cp_async16_ok(q.shape, q.stride(), q.data_ptr())
    lse = tfa.new_lse(q)
    out = tfa.flash_attention(q, k, v, causal=True, lse=lse)
    got = tfa.flash_attention_bwd_fp32(q, k, v, out, lse, dy, causal=True)
    torch.cuda.synchronize()
    _assert_close(out, q.contiguous(), k.contiguous(), v.contiguous(), True)
    want = tfa.flash_attention_backward(q, k, v, dy, True)
    assert _bwd_rel(got, want) <= 2e-4


@pytest.mark.cuda
def test_tf32_mma_rate_is_within_the_tensor_cores(cuda_device):
    """The TF32 mma.sync probe runs and reads a rate between a tenth of
    an H100's 495 TFLOP/s of dense TF32 and that peak."""
    assert 49.5 < tfa.tf32_mma_rate() <= 495


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


# (S, H, KV, window): windows that are no tile multiple, one of 1, one
# a tile wide, ragged S, G = 1, 2 and 10 (recurrentgemma's 10 over 1)
WINDOW_CASES = [(300, 4, 2, 100), (1000, 8, 4, 129), (257, 10, 1, 128),
                (200, 4, 4, 1), (640, 8, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("S,H,KV,window", WINDOW_CASES)
def test_flash_window_kernel_matches_plain(cuda_device, dtype, hd, S, H, KV,
                                           window):
    """Both forward routes with a causal sliding window against the plain
    version with the same window; one launch a call."""
    q, k, v = _qkv(cuda_device, 2, S, H, KV, hd, dtype, seed=6)
    n0 = _launches(dtype)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert _launches(dtype) == n0 + 1
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    else:
        rel = (got.float() - want.float()).norm(dim=-1) \
            / want.float().norm(dim=-1)
        assert rel.max().item() <= 1e-2


@pytest.mark.cuda
def test_flash_window_refuses_a_window_without_causal(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 64, 2, 1, 64, torch.bfloat16)
    counts = ops.launch_counts()
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, causal=False, window=16)
    assert ops.launch_counts() == counts


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-12b", "mixtral-8x7b",
                                  "kimi-k2-1t-a32b", "mamba2-1.3b",
                                  "recurrentgemma-2b", "qwen2-vl-2b",
                                  "whisper-medium"])
def test_reduced_model_on_card_matches_cpu(cuda_device, arch):
    """Same weights, fp32: kernels on the card vs plain versions on the CPU,
    at a ragged S=40 (mamba2: 40 is a multiple of its reduced chunk 8); vlm
    with patch embeddings, audio with frames."""
    cfg = registry.load_config(arch).reduced()
    cpu = registry.init_params(cfg, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda_device)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), generator=g)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(2, cfg.vision_tokens, cfg.d_model,
                                            generator=g)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, cfg.encoder_frames, cfg.d_model,
                                      generator=g)
    want = serve.prefill_logits(cpu, batch)
    n0 = trn.rmsnorm.launches
    got = serve.prefill_logits(
        gpu, {k: v.to(cuda_device) for k, v in batch.items()}).cpu()
    norms = 3 * cfg.n_layers + 2 * cfg.encoder_layers + 2 \
        if cfg.family == "audio" else 2 * cfg.n_layers + 1
    assert trn.rmsnorm.launches == n0 + norms
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


BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "BENCH_verify.json")


def _fires(reports):
    return sum(sum(((r.get("stats") or {}).get("lemma_fires") or {})
                   .values()) for r in reports.values())


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["gpt@dp2", "gpt@dp2xtp2",
                                  "gemma3-12b@dp2xtp2", "mixtral-8x7b@tp2"])
def test_check_model_on_the_card(cuda_device, no_tf32, task):
    """Whole-model checks traced on the card: BENCH_verify.json's fires,
    and each clean obligation's certificate replayed there."""
    from repro_torch.modelcheck import check_model, decompose
    from repro_torch.modelcheck.blocks import replay_inputs
    model, plan = task.split("@")
    r = check_model(model, plan, workers=0, device=cuda_device)
    bench = json.load(open(BENCH))["modelcheck"][task]
    assert r.ok and r.verdict == "certificate"
    assert (r.total_blocks, r.unique_obligations, _fires(r.reports)) == \
        (bench["total_blocks"], bench["unique_obligations"],
         bench["lemma_fires"])
    dec = decompose(model, plan, device=cuda_device)
    for key in dec.obset.keys_in_order():
        ob = dec.obset.unique[key]
        got, want = replay(ob.to_strategy_spec(name=key), cuda_device,
                           inputs=replay_inputs(ob, device=cuda_device))
        assert all(v.device.type == "cuda" for v in got.values())
        assert max_rel_excess(got, want) <= 1.0


@pytest.mark.cuda
def test_model_bug_localizes_on_the_card(cuda_device):
    from repro_torch.modelcheck import check_model
    r = check_model("gpt", "dp2xtp2", bug="wrong_spec", bug_layer=3,
                    workers=0, device=cuda_device)
    assert r.ok and r.failing_blocks == [4]


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,degree", [("dp", 2), ("dp_accum", 2),
                                             ("fsdp", 2), ("tp_dp_2d", (4, 4))])
def test_check_train_on_the_card(cuda_device, no_tf32, strategy, degree):
    from repro_torch.api import degree_token
    from repro_torch.gradcheck import (check_train, get_train_strategy,
                                       replay_train)
    r = check_train(strategy, degree=degree, device=cuda_device)
    bench = json.load(open(BENCH))["gradcheck"][
        f"train@{strategy}@deg{degree_token(degree)}"]
    assert r.ok and _fires(r.reports) == bench["lemma_fires"]
    for spec in get_train_strategy(strategy).build(degree=degree).values():
        got, want = replay_train(spec, cuda_device)
        assert max_rel_excess(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("argv,rc", [
    (["--model", "gpt", "--plan", "dp2xtp2"], 0),
    (["--model", "gpt", "--inject-bug", "wrong_spec", "--bug-layer", "3"], 1),
    (["--train", "dp_accum"], 0),
    (["--train", "dp_accum", "--inject-bug", "accum_no_rescale"], 1)])
def test_model_and_train_cli_on_the_card(cuda_device, argv, rc):
    """The CLI's default device is the card: no --device needed."""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.verify",
                        *argv], capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=src))
    assert r.returncode == rc, r.stderr
    if rc == 0:
        assert "REFINEMENT HOLDS" in r.stdout
    else:
        assert "failing blocks [4]" in r.stdout \
            or "failing parameters ['w2']" in r.stdout


# ---------------------------------------------------------------------------
# serving-path checks and training on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("argv,rc", [
    (["--serve", "tp_decode"], 0),
    (["--serve", "tp_decode", "--inject-bug", "stale_cache_shard"], 1)])
def test_serve_cli_on_the_card(cuda_device, argv, rc):
    """--serve on the CLI's default device, the card."""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.verify",
                        *argv], capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=src))
    assert r.returncode == rc, r.stderr
    assert ("SERVING-PATH REFINEMENT HOLDS" if rc == 0
            else "failing steps ['step3']") in r.stdout


def _grads(fn, inputs):
    """(output, gradients of sum(output * w)) for a fixed random w."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*xs)
    w = torch.randn(out.shape, generator=torch.Generator(
        device=out.device).manual_seed(7), device=out.device).to(out.dtype)
    return out, torch.autograd.grad((out.float() * w.float()).sum(), xs)


def _rel_rms(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D", [(4, 128), (1024, 768), (4097, 4096)])
def test_rmsnorm_function_gradients_match_plain(cuda_device, rows, D, dtype):
    """The kernel under autograd (ops.rmsnorm on tensors that need grad)
    launches the kernel and gives autograd's gradients of the plain
    version: fp32 within 1e-5 relative RMS, bf16 within 2e-2."""
    x, s = _norm_inputs(cuda_device, rows, D, dtype, seed=3)
    n0 = trn.rmsnorm.launches
    out, got = _grads(ops.rmsnorm, (x, s))
    assert trn.rmsnorm.launches == n0 + 1 and out.grad_fn is not None
    _, want = _grads(trn.rmsnorm_plain, (x, s))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype and _rel_rms(g, w) <= tol
    with torch.no_grad():                    # no autograd: the direct launch
        assert ops.rmsnorm(x.requires_grad_(True), s).grad_fn is None
    assert trn.rmsnorm.launches == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 128, 4, 2, 32),
                                         (1, 256, 12, 12, 64),
                                         (1, 200, 8, 2, 128)])
def test_flash_function_gradients_match_plain(cuda_device, dtype, causal, B,
                                              S, H, KV, hd):
    """The kernel under autograd gives autograd's gradients of the plain
    version (GQA, causal or not): fp32 within 1e-5 relative RMS, bf16
    within 2e-2."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    n0 = ops.launch_counts()["flash_attention"]
    out, got = _grads(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=causal), (q, k, v))
    assert ops.launch_counts()["flash_attention"] == n0 + 1
    assert out.grad_fn is not None
    _, want = _grads(lambda q, k, v: tfa.flash_attention_plain(
        q, k, v, causal=causal), (q, k, v))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for gt, w in zip(got, want):
        assert gt.shape == w.shape and _rel_rms(gt, w) <= tol


def _bwd_rel(got, want):
    return max(_rel_rms(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [256, 1000])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 256])
def test_flash_backward_kernel_matches_plain(cuda_device, hd, causal, G, S):
    """K2's bf16 backward kernel against the closed form (its plain
    version): dq, dk and dv each within 1e-2 relative RMS (P and dS in
    bf16), one launch a call; the forward's LSE within 1e-3 of the plain
    one's."""
    q, k, v = _qkv(cuda_device, 2, S, 2 * G, 2, hd, torch.bfloat16)
    dy = torch.randn_like(q)
    lse = tfa.new_lse(q)
    out = tfa.flash_attention(q, k, v, causal=causal, lse=lse)
    _, lse_ref = tfa.flash_attention_plain_lse(q, k, v, causal=causal)
    n0 = tfa.flash_attention_bwd_bf16.launches
    got = tfa.flash_attention_bwd_bf16(q, k, v, out, lse, dy, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_bf16.launches == n0 + 1
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    want = tfa.flash_attention_backward(q, k, v, dy, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
    assert _bwd_rel(got, want) <= 1e-2


@pytest.mark.cuda
def test_flash_backward_reads_strided_views(cuda_device):
    """q, k, v as views of one packed tensor and dy a non-contiguous view
    (copied, as TMA cannot step its head stride)."""
    qkv = torch.randn(1, 300, 12, 128, device=cuda_device).bfloat16()
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    dy = torch.randn(1, 300, 8, 136, device=cuda_device).bfloat16()[..., :128]
    lse = tfa.new_lse(q)
    out = tfa.flash_attention(q, k, v, causal=True, lse=lse)
    got = tfa.flash_attention_bwd_bf16(q, k, v, out, lse, dy, causal=True)
    want = tfa.flash_attention_backward(q, k, v, dy, True)
    assert _bwd_rel(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("S", [256, 1000])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 256])
def test_flash_fp32_backward_kernel_matches_plain(cuda_device, hd, causal, G,
                                                  S):
    """K2's fp32 backward kernel against the closed form: dq, dk and dv
    each within 2e-4 relative RMS (3xTF32 products, ~2^-21 each), one
    launch a call; the fp32 forward's LSE within 1e-5 of the plain
    one's."""
    q, k, v = _qkv(cuda_device, 2, S, 2 * G, 2, hd, torch.float32)
    dy = torch.randn_like(q)
    lse = tfa.new_lse(q)
    out = tfa.flash_attention(q, k, v, causal=causal, lse=lse)
    _, lse_ref = tfa.flash_attention_plain_lse(q, k, v, causal=causal)
    n0 = tfa.flash_attention_bwd_fp32.launches
    got = tfa.flash_attention_bwd_fp32(q, k, v, out, lse, dy, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_fp32.launches == n0 + 1
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    want = tfa.flash_attention_backward(q, k, v, dy, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
    assert _bwd_rel(got, want) <= 2e-4


def _check_backward(device, B, S, H, KV, hd, dtype, causal, window):
    """Both backward kernels against the closed form with the same mask
    (bf16 1e-2, fp32 2e-4 relative RMS each), from the forward's LSE (bf16
    1e-3, fp32 1e-5 of the plain one's), one launch a call. A window of 1
    makes dq and dk 0 exactly (each query sees only its own key: P = 1,
    dS = dP - delta = 0); there each element is held within the limit of 0
    instead."""
    q, k, v = _qkv(device, B, S, H, KV, hd, dtype, seed=7)
    dy = torch.randn_like(q)
    lse = tfa.new_lse(q)
    out = tfa.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    _, lse_ref = tfa.flash_attention_plain_lse(q, k, v, causal=causal,
                                               window=window)
    bf16 = dtype == torch.bfloat16
    assert (lse - lse_ref).abs().max().item() <= (1e-3 if bf16 else 1e-5)
    kernel = tfa.BACKWARD_KERNELS[tfa.ROUTES[dtype]]
    n0 = kernel.launches
    got = kernel(q, k, v, out, lse, dy, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    want = tfa.flash_attention_backward(q, k, v, dy, causal, window)
    limit = 1e-2 if bf16 else 2e-4
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        if w.abs().max().item() == 0:
            assert g.float().abs().max().item() <= limit
        else:
            assert _rel_rms(g, w) <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("S,H,KV,window", WINDOW_CASES)
def test_flash_window_backward_kernels_match_plain(cuda_device, dtype, hd, S,
                                                   H, KV, window):
    """Both backward kernels with a window against the closed form with the
    same window (``_check_backward``)."""
    _check_backward(cuda_device, 2, S, H, KV, hd, dtype, True, window)


def _family_train_attn():
    """Each family's training attention (chip_smoke.py phase 13): the
    (H, KV, hd, causal, window) of every K2 shape ``train_shapes`` gives
    its published config at its training batch (kimi-k2's published
    attention too), at a short S: a ragged one past a window that bites at
    the training S (mixtral's window of 4096 = S does not), whisper's
    encoder at its frames, else 300."""
    cases = {}
    for arch in chip_smoke.TRAIN_ARCHS:
        B, S = chip_smoke.TRAIN_BATCH.get(arch, (1, chip_smoke.S_LONG))
        for s in chip_smoke.train_shapes(registry.load_config(arch), B, S):
            if s["kernel"] != "flash_attention":
                continue
            _, S_train, H, KV, hd = s["shape"]
            w, causal = s["window"], s["causal"]
            short = w + 257 if w and w < S_train else 300 if causal \
                else S_train
            cases["-".join(filter(None, (arch, s["part"])))] = (
                short, H, KV, hd, causal, w)
    return cases


FAMILY_TRAIN_ATTN = _family_train_attn()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", sorted(FAMILY_TRAIN_ATTN))
def test_flash_backward_kernels_at_family_training_shapes(cuda_device,
                                                          family, dtype):
    """Both backward kernels at each family's training heads, head dim,
    mask and window (``_check_backward``, B = 1)."""
    S, H, KV, hd, causal, window = FAMILY_TRAIN_ATTN[family]
    _check_backward(cuda_device, 1, S, H, KV, hd, dtype, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [128, 768, 4096, 8192, 1024, 1536, 2048, 2560,
                               3840, 5376])
@pytest.mark.parametrize("rows", [1, 4, 133, 4097])
def test_rmsnorm_backward_kernel_matches_plain(cuda_device, rows, D, dtype):
    """K1's backward kernel against the closed form: dx within the
    forward's limits (1e-5 / 3e-2), dscale within 1e-4 / 1e-2, one launch
    a call."""
    x, s = _norm_inputs(cuda_device, rows, D, dtype, seed=5)
    dy = torch.randn_like(x)
    n0 = trn.rmsnorm_bwd.launches
    dx, ds = trn.rmsnorm_bwd(x, s, dy)
    torch.cuda.synchronize()
    assert trn.rmsnorm_bwd.launches == n0 + 1
    want_dx, want_ds = trn.rmsnorm_backward(x, s, dy)
    tol_dx, tol_ds = (1e-5, 1e-4) if dtype == torch.float32 else (3e-2, 1e-2)
    assert dx.dtype == ds.dtype == dtype
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=tol_dx,
                               rtol=tol_dx)
    torch.testing.assert_close(ds.float(), want_ds.float(), atol=tol_ds,
                               rtol=tol_ds)


@pytest.fixture
def no_closed_forms(monkeypatch):
    """The closed-form backwards made to raise: a card call that reaches
    one fails."""
    def refuse(*a, **k):
        raise AssertionError("a closed-form backward ran on the card")
    monkeypatch.setattr(tfa, "flash_attention_backward", refuse)
    monkeypatch.setattr(trn, "rmsnorm_backward", refuse)


@pytest.mark.cuda
def test_one_autograd_call_launches_one_forward_and_one_backward(
        cuda_device, no_closed_forms):
    """ops.rmsnorm and ops.flash_attention in bf16, and ops.flash_attention
    in fp32 with a window, under autograd: exactly one forward and one
    backward kernel launch each, and no closed form."""
    x, s = _norm_inputs(cuda_device, 1024, 768, torch.bfloat16)
    q, k, v = _qkv(cuda_device, 2, 256, 8, 2, 64, torch.bfloat16)
    ops.reset_launch_counts()
    _grads(ops.rmsnorm, (x, s))
    _grads(lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
           (q, k, v))
    _grads(lambda q, k, v: ops.flash_attention(q, k, v, causal=True,
                                               window=100),
           (q.float(), k.float(), v.float()))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["rmsnorm"], counts["rmsnorm_bwd"],
            counts["flash_attention_bf16"],
            counts["flash_attention_bwd_bf16"],
            counts["flash_attention_fp32"],
            counts["flash_attention_bwd_fp32"]) == (1, 1, 1, 1, 1, 1)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device, no_tf32):
    """One step of reduced gpt (fp32) on the card and on the CPU from the
    same weights and batch: the loss, the gradient norm and the updated
    parameters agree within 1e-4; the step launched both kernels forward
    (2 norms a layer + the final one; one attention a layer) and their
    backward kernels as often (K2's through its fp32 route)."""
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, trainable
    cfg = registry.load_config("gpt").reduced()
    cpu = trainable(registry.init_params(cfg, seed=0, device="cpu"))
    gpu = copy.deepcopy(cpu).to(cuda_device)
    ds = SyntheticTextDataset(vocab=cfg.vocab, seq_len=64, batch=2)
    step = make_train_step(cfg)
    _, _, want = step(cpu, adamw.init(dict(cpu.named_parameters())),
                      ds.batch_at(0, "cpu"))
    ops.reset_launch_counts()
    _, _, got = step(gpu, adamw.init(dict(gpu.named_parameters())),
                     ds.batch_at(0, cuda_device))
    counts = ops.launch_counts()
    assert counts["rmsnorm"] == 2 * cfg.n_layers + 1
    assert counts["flash_attention_fp32"] == cfg.n_layers
    assert counts["flash_attention_bf16"] == 0
    assert counts["rmsnorm_bwd"] == 2 * cfg.n_layers + 1
    assert counts["flash_attention_bwd_bf16"] == 0
    assert counts["flash_attention_bwd_fp32"] == cfg.n_layers
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4,
                                   atol=0)
    for (n, p), (_, q) in zip(cpu.named_parameters(),
                              gpu.named_parameters()):
        torch.testing.assert_close(q.detach().cpu(), p.detach(), rtol=1e-4,
                                   atol=1e-4, msg=n)


@pytest.mark.cuda
def test_launch_train_on_the_card(cuda_device, tmp_path):
    """python -m repro_torch.launch.train on its default device, the card,
    with a checkpoint."""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--steps", "11", "--ckpt", str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=src))
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "10"]
    assert (tmp_path / "ckpt_00000011.msgpack").exists()


# --- AdamW's kernels against their plain version --------------------------

ADAMW_PAIRS = [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.float32)]
# leaf sizes; "zero" gets a zero gradient, "offset" lies one element into
# its buffer (off the 16-byte grain: the kernel's scalar loop)
ADAMW_SIZES = {"one": 1, "seven": 7, "row": 4096, "ragged": 4096 * 11 + 3,
               "zero": 4096, "offset": 4097}


def _adamw_leaves(device, pair, sizes, seed):
    """(params, grads) of ``sizes``, drawn from ``seed``: the same values,
    shapes and offsets on every call."""
    g = torch.Generator(device=device).manual_seed(seed)
    params, grads = {}, {}
    for name, n in sizes.items():
        off = int(name == "offset")
        params[name] = torch.randn(n + off, generator=g,
                                   device=device).to(pair[0])[off:]
        grads[name] = (torch.randn(n, generator=g, device=device)
                       * 0.5).to(pair[1])
    if "zero" in grads:
        grads["zero"].zero_()
    return params, grads


def _adamw_kernel_step(params, grads, state, cfg, gnorm):
    """One update by ``adamw_update`` a leaf, given the plain version's
    scalars: its norm's scale and its schedule."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim import adamw
    step, lr, bc1, bc2 = adamw.step_scalars(state, cfg)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) \
        if cfg.clip_norm else None
    args = kadamw.update_args(cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
    for n, p in params.items():
        kadamw.adamw_update(p, grads[n], state["mu"][n], state["nu"][n],
                            scale, lr, bc1, bc2, args)
    state["step"] = step


def _adamw_plain_step(grads, state, params, cfg):
    """One update by the plain version, as ``optim.adamw.update`` makes it;
    returns the norm."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim import adamw
    step, lr, bc1, bc2 = adamw.step_scalars(state, cfg)
    gnorm = kadamw.update_plain(grads, state["mu"], state["nu"], params, cfg,
                                lr, bc1, bc2)
    state["step"] = step
    return gnorm


def _assert_adamw_bits(kp, ks, pp, ps):
    for n in pp:
        for what, got, want in (("p", kp[n], pp[n]), ("m", ks["mu"][n],
                                                      ps["mu"][n]),
                                ("v", ks["nu"][n], ps["nu"][n])):
            assert torch.equal(got, want), (n, what)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [0.0, 0.1], ids=["no_decay", "decay"])
@pytest.mark.parametrize("clip", [0.0, 1e6, 0.05],
                         ids=["no_clip", "clip", "clip_biting"])
@pytest.mark.parametrize("pair", ADAMW_PAIRS,
                         ids=["bf16_fp32", "bf16_bf16", "fp32_fp32"])
def test_adamw_update_kernel_is_the_plain_version(cuda_device, pair, clip,
                                                  decay):
    """Three steps of ``adamw_update`` a leaf against the plain version on
    the card, given the same scalars: every parameter and both moments
    equal bit for bit, at leaves of 1, 7, 4096 and 4096 * 11 + 3 elements,
    a zero gradient and a leaf off the 16-byte grain."""
    from repro_torch.optim import adamw
    cfg = adamw.AdamWConfig(clip_norm=clip, weight_decay=decay,
                            warmup_steps=2)
    pp, _ = _adamw_leaves(cuda_device, pair, ADAMW_SIZES, 0)
    kp, _ = _adamw_leaves(cuda_device, pair, ADAMW_SIZES, 0)
    assert kp["offset"].data_ptr() % 16
    ps, ks = adamw.init(pp), adamw.init(kp)
    for i in range(3):
        _, grads = _adamw_leaves(cuda_device, pair, ADAMW_SIZES, i + 1)
        gnorm = _adamw_plain_step(grads, ps, pp, cfg)
        _adamw_kernel_step(kp, grads, ks, cfg, gnorm)
        torch.cuda.synchronize()
        _assert_adamw_bits(kp, ks, pp, ps)
    assert int(ks["step"]) == int(ps["step"]) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ADAMW_PAIRS,
                         ids=["bf16_fp32", "bf16_bf16", "fp32_fp32"])
def test_adamw_update_kernel_on_a_leaf_past_2_31_bytes(cuda_device, pair):
    """A leaf whose moments pass 2**31 bytes (64-bit indices), ragged, with
    the clip biting and weight decay: bit for bit the plain version's (its
    runs of rows past UPDATE_CHUNK)."""
    from repro_torch.optim import adamw
    sizes = {"big": (1 << 29) + 3}
    cfg = adamw.AdamWConfig(clip_norm=0.05, warmup_steps=1)
    pp, grads = _adamw_leaves(cuda_device, pair, sizes, 0)
    # (rows, 1): the plain version updates runs of rows past UPDATE_CHUNK
    pp, grads = ({n: t.view(-1, 1) for n, t in d.items()}
                 for d in (pp, grads))
    kp = {n: p.clone() for n, p in pp.items()}
    ps, ks = adamw.init(pp), adamw.init(kp)
    assert ps["mu"]["big"].numel() * 4 > 1 << 31
    gnorm = _adamw_plain_step(grads, ps, pp, cfg)
    _adamw_kernel_step(kp, grads, ks, cfg, gnorm)
    torch.cuda.synchronize()
    _assert_adamw_bits(kp, ks, pp, ps)
    del pp, kp, ps, ks, grads
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_adamw_sumsq_is_the_fp64_norm_and_repeats(cuda_device):
    """The global norm of fp32 and bf16 leaves (one of 2**27 elements, one
    ragged, one of 7) within 1e-6 relative of an fp64 sum, the scale
    min(clip / (norm + 1e-9), 1), and the same bits from a second call."""
    from repro_torch.kernels import adamw as kadamw
    g = torch.Generator(device=cuda_device).manual_seed(3)
    grads = [torch.randn(n, generator=g, device=cuda_device).to(dt)
             for n, dt in (((1 << 27), torch.float32),
                           (4096 * 11 + 3, torch.bfloat16),
                           (7, torch.float32), (5000, torch.bfloat16))]
    want = float(torch.sqrt(sum((t.double() ** 2).sum() for t in grads)))
    gnorm, scale = kadamw.adamw_sumsq(grads, 1.0)
    again = kadamw.adamw_sumsq(grads, 1.0)
    torch.cuda.synchronize()
    assert abs(float(gnorm) - want) <= 1e-6 * want
    assert float(scale) == pytest.approx(1.0 / (want + 1e-9), rel=1e-6)
    assert torch.equal(gnorm, again[0]) and torch.equal(scale, again[1])
    assert float(kadamw.adamw_sumsq(grads[2:3], 1e9)[1]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["no_clip", "clip"])
def test_adamw_update_launches_a_kernel_a_leaf_without_a_sync(cuda_device,
                                                              clip):
    """``optim.adamw.update`` on CUDA leaves under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync; each
    kernel launches once a leaf (the norm's only where clipping is on),
    and the norm and the updated leaves are the plain version's."""
    from repro_torch.optim import adamw
    pair = ADAMW_PAIRS[0]
    cfg = adamw.AdamWConfig(clip_norm=clip)
    kp, grads = _adamw_leaves(cuda_device, pair, ADAMW_SIZES, 0)
    pp, _ = _adamw_leaves(cuda_device, pair, ADAMW_SIZES, 0)
    ks, ps = adamw.init(kp), adamw.init(pp)
    warm, _ = _adamw_leaves(cuda_device, pair, ADAMW_SIZES, 0)
    adamw.update(grads, adamw.init(warm), warm, cfg)  # loads the library
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, gnorm = adamw.update(grads, ks, kp, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = ops.launch_counts()
    assert counts["adamw_update"] == len(kp)
    assert counts["adamw_sumsq"] == (len(kp) if clip else 0)
    want = _adamw_plain_step(grads, ps, pp, cfg)
    torch.testing.assert_close(gnorm, want, rtol=1e-6, atol=0)
    for n in kp:
        torch.testing.assert_close(ks["mu"][n], ps["mu"][n], rtol=1e-6,
                                   atol=1e-12)
        torch.testing.assert_close(kp[n].float(), pp[n].float(), rtol=1e-2,
                                   atol=1e-6)


@pytest.mark.cuda
def test_adamw_kernels_refuse_what_they_do_not_take(cuda_device):
    """A leaf that is not contiguous, gradients of another shape, and a
    (parameter, gradient) dtype pair the kernels have no instance for
    raise, with nothing launched and nothing falling back."""
    from repro_torch.optim import adamw
    cfg = adamw.AdamWConfig()

    def attempt(p, g):
        ops.reset_launch_counts()
        params = {"w": p}
        adamw.update({"w": g}, adamw.init(params), params, cfg)

    dev = cuda_device
    with pytest.raises(ValueError, match="not contiguous"):
        attempt(torch.zeros(8, 4, device=dev).t(), torch.ones(4, 8, device=dev))
    with pytest.raises(ValueError, match="shapes"):
        attempt(torch.zeros(4, 8, device=dev), torch.ones(8, 4, device=dev))
    for p_dt, g_dt in ((torch.float32, torch.bfloat16),
                       (torch.float16, torch.float32)):
        with pytest.raises(TypeError, match="the kernels take"):
            attempt(torch.zeros(4, 8, dtype=p_dt, device=dev),
                    torch.ones(4, 8, dtype=g_dt, device=dev))
    assert not any(ops.launch_counts().values())


@pytest.fixture
def one_rank_mesh(cuda_device):
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    yield make_mesh((1, 1), ("data", "model"), device="cuda")
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_on_dtensors_are_the_direct_calls(one_rank_mesh, dtype):
    """K1 and K2 given DTensors on a one-rank mesh reach the same kernels
    through their custom ops: bit-equal to the direct calls, one launch
    a call."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.specs import distribute
    mesh = one_rank_mesh
    x, s = _norm_inputs("cuda", 1024, 4096, dtype)
    want = ops.rmsnorm(x, s)
    xd = distribute(x, mesh, (Shard(0), Replicate()))
    sd = distribute(s, mesh, (Replicate(), Replicate()))
    n0 = trn.rmsnorm.launches
    got = ops.rmsnorm(xd, sd)
    torch.cuda.synchronize()
    assert trn.rmsnorm.launches == n0 + 1
    assert torch.equal(got.full_tensor(), want)
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(2, 256, H, 128, generator=g, device="cuda")
               .to(dtype) for H in (8, 2, 2))
    want = ops.flash_attention(q, k, v, causal=True)
    pl = (Shard(0), Shard(2))
    qd, kd, vd = (distribute(t, mesh, pl) for t in (q, k, v))
    n0 = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(qd, kd, vd, causal=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == n0 + 1
    assert torch.equal(got.full_tensor(), want)
    # k and v replicated on heads, q sharded: the GQA case
    kr, vr = (distribute(t, mesh, (Shard(0), Replicate())) for t in (k, v))
    got = ops.flash_attention(qd, kr, vr, causal=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == n0 + 2
    assert torch.equal(got.full_tensor(), want)


@pytest.mark.cuda
def test_backward_on_dtensors_launches_the_kernels(one_rank_mesh,
                                                   no_closed_forms):
    """Gradients through the custom ops on a one-rank mesh (bf16): each
    backward reaches its kernel on the local shards, one launch a call,
    and gives the direct path's gradients (1e-2 relative RMS: dQ's fp32
    atomics sum in another order)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.specs import distribute
    mesh = one_rank_mesh
    x, s = _norm_inputs("cuda", 1024, 4096, torch.bfloat16)
    q, k, v = _qkv("cuda", 2, 256, 8, 2, 128, torch.bfloat16)
    _, want_norm = _grads(ops.rmsnorm, (x, s))
    _, want_attn = _grads(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=True), (q, k, v))
    xd = distribute(x, mesh, (Shard(0), Replicate()))
    sd = distribute(s, mesh, (Replicate(), Replicate()))
    pl = (Shard(0), Shard(2))
    qd, kd, vd = (distribute(t, mesh, pl) for t in (q, k, v))
    def dgrads(fn, inputs):
        # _grads' loss, its weights placed as the output
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*xs)
        w = torch.randn(out.shape, generator=torch.Generator(
            device="cuda").manual_seed(7), device="cuda").to(out.dtype)
        w = distribute(w, mesh, out.placements)
        return torch.autograd.grad((out.float() * w.float()).sum(), xs)

    ops.reset_launch_counts()
    got_norm = dgrads(ops.rmsnorm, (xd, sd))
    got_attn = dgrads(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=True), (qd, kd, vd))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["rmsnorm"], counts["rmsnorm_bwd"],
            counts["flash_attention_bf16"],
            counts["flash_attention_bwd_bf16"]) == (1, 1, 1, 1)
    for g, w in zip(got_norm + got_attn, want_norm + want_attn):
        assert _rel_rms(g.full_tensor(), w) <= 1e-2


@pytest.mark.cuda
def test_kernels_on_fake_cuda_tensors_launch_nothing(cuda_device):
    from torch._subclasses.fake_tensor import FakeTensorMode
    ops.reset_launch_counts()
    with FakeTensorMode():
        x = torch.empty(4096, 4096, dtype=torch.bfloat16, device="cuda")
        y = ops.rmsnorm(x, torch.empty(4096, dtype=torch.bfloat16,
                                       device="cuda"))
        q = torch.empty(1, 4096, 32, 128, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(1, 4096, 4, 128, dtype=torch.bfloat16, device="cuda")
        o = ops.flash_attention(q, k, k, causal=True)
    assert (tuple(y.shape), y.dtype, y.device.type) == \
        ((4096, 4096), torch.bfloat16, "cuda")
    assert (tuple(o.shape), o.dtype) == ((1, 4096, 32, 128), torch.bfloat16)
    assert all(n == 0 for n in ops.launch_counts().values())
