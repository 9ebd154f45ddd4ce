#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 prints the card and its power limit, builds the CUDA kernels with
nvcc (sm_90a, one process per source, in parallel), prints ptxas's
registers, shared memory and spills for each kernel, each attention
library's dynamic shared memory by head dim and the RMSNorm ring's at
D=4096 bf16 and D=8192 fp32, and the count of HGMMA (wgmma) instructions
in the bf16 attention library's SASS, which must not be 0. Phase 1 holds
each kernel against its plain PyTorch version on the card, at the JAX
kernel tests' shapes, at yi-9b's own and at gemma3-12b's global layers'
(16 heads over 8, hd 256), in float32 and bfloat16 (RMSNorm: both launch
plans at every shape; attention: two routes, bf16 on the tensor cores and
float32 scalar), and times the kernel, the plain version and one PyTorch
library call beside the card's bound, and the host's time to enqueue one
call (97 RMSNorm calls in a row, 48 attention calls, as a forward makes
them); an empty kernel of the port's library, timed the same way, gives
the launch floor under the short calls, and both RMSNorm plans are timed
over row counts, where plan() switches from one to the other; it also
holds the whole model on the card against the same model on the CPU at a
reduced size. Phase 2 serves yi-9b at full width and depth in bfloat16
with random weights from a seed: parallel prefill of 4 x 256 and 1 x 4096
tokens, sequential prefill of the 4 prompts (whose logits must agree with
the parallel prefill's), and 32 greedy decode steps; the kernels' launch
counters must show exactly the launches this path makes: RMSNorm 97 a
forward or step (28,227 in all, by row count and by plan as plan() says),
the bf16 attention route 48 per prefill (144 in all), the float32 route
never. Phase 3 profiles the two prefills and four decode steps
(torch.profiler) and prints the device busy share, the kernels that take
the most time and RMSNorm's share.

The last line is {"ok": true, "device": {...}}; the line before it is the
kernels' JSON record. Any failure raises and exits non-zero, and the
script exits non-zero without a CUDA device.
"""
import copy
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Data-sheet peaks (dense): bytes/s of device memory, bf16 tensor-core and
# fp32 (outside the tensor cores) operations/s.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H200": (4.8e12, 989e12, 67e12),
    "H100": (3.35e12, 989e12, 67e12),   # SXM (80GB HBM3)
}

B_PROMPT, S_PROMPT, S_LONG, N_DECODE = 4, 256, 4096, 32
N_LAYERS = 48                          # yi-9b
N_NORMS = 2 * N_LAYERS + 1             # RMSNorm calls a forward or step makes
D_MODEL = 4096                         # yi-9b
BF16_LIB = "flash_attention_sm90"      # csrc/ source of the bf16 route
# Sequential (decode-path) vs parallel (prefill-path) logits in bf16: the
# two paths round at different places (the flash kernel's tiled online
# softmax vs the decode attention's one pass, GEMM vs GEMV summation order)
# and the error compounds over 48 residual layers. bf16's unit roundoff is 2^-8 = 3.9e-3;
# allow ~13 of it in relative RMS over all logits.
SEQ_VS_PAR_REL_RMS = 5e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def peaks_for(name):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def time_ms(fn, iters, flush):
    """Mean device time of ``fn`` by CUDA events, L2 flushed before each.

    A ~1 ms device sleep is queued ahead of each timed call, so that the
    call's launches are all enqueued before the card reaches them and the
    host's launch latency stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def host_us(fn, calls=N_LAYERS):
    """Host wall time per call, in us, of ``calls`` back-to-back calls with
    no synchronization between them: what the host spends to enqueue one
    call. A ~10 ms device sleep queued first keeps the card busy meanwhile,
    so the card's own pace does not block the host."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / calls * 1e6


def max_err(got, want, tol):
    """max |got - want|; fails unless |got - want| <= tol + tol * |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    check(bool(torch.all(diff <= tol + tol * want.abs())),
          f"results disagree: max abs err "
          f"{diff.max().item()} beyond tol {tol}")
    return diff.max().item()


def row_rel_err(got, want):
    """Worst relative error of an output row: max over rows of
    ||got - want|| / ||want|| along the last dim."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def cuobjdump():
    """The CUDA toolkit's cuobjdump (beside the nvcc that builds the
    kernels)."""
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
               / "cuobjdump")


def phase0():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build, rmsnorm as rn
    t = time.perf_counter()
    libs = build.build()
    nvcc_s = time.perf_counter() - t
    print(f"build: nvcc {nvcc_s:.1f} s ({len(libs)} sources at once)")
    n_sm = rn.sm_count(0)
    for name, path in libs.items():
        print(f"[ptxas] {path.name}\n{build.ptxas_report(name)}")
        if name.startswith("flash_attention"):
            smem_bytes = getattr(ctypes.CDLL(str(path)),
                                 f"repro_{name}_smem_bytes")
            smem_bytes.argtypes = [ctypes.c_int]
            smem_bytes.restype = ctypes.c_int
            smem = {hd: smem_bytes(hd) for hd in (32, 64, 128, 256)}
            print(f"[smem] {name}: dynamic shared memory a block, by head "
                  f"dim: {smem}")
        elif name == "rmsnorm":
            for D, dt in ((4096, torch.bfloat16), (8192, torch.float32)):
                p = rn.plan(S_LONG, D, dt, n_sm)
                print(f"[smem] rmsnorm: {p.name} plan at D={D} {dt}, "
                      f"{n_sm} SMs: {p.stages} stages of {D * dt.itemsize} "
                      f"bytes, {p.smem} bytes of dynamic shared memory a "
                      f"block, grid {p.grid} x {p.threads} threads")
    sass = subprocess.run([cuobjdump(), "-sass", str(libs[BF16_LIB])],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
    print(f"[sass] {libs[BF16_LIB].name}: {hgmma} HGMMA instructions")
    check(hgmma > 0, "the bf16 attention library has no wgmma (HGMMA)")
    return smi


def phase1(peaks):
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    bw, bf16_rate, f32_rate = peaks
    rate = {torch.bfloat16: bf16_rate, torch.float32: f32_rate}
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    records = []

    def bound(nbytes, nops, dt):
        t_bytes, t_ops = nbytes / bw * 1e3, nops / rate[dt] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    # K1 RMSNorm: the JAX test shapes, then yi-9b's decode (4 rows),
    # prefill (4 x 256) and long-prefill (1 x 4096) rows. Every shape runs
    # in both plans, whichever plan() picks, and through rmsnorm(), which
    # picks; the timed shapes are timed through rmsnorm(). Tolerances: the
    # JAX test's (fp32 rounding / one bf16 output ulp).
    n_sm = rn.sm_count(0)
    for shape, timed in [((4, 128), False), ((2, 16, 256), False),
                         ((1, 7, 384), False), ((3, 5, 8, 128), False),
                         ((B_PROMPT, D_MODEL), True),
                         ((B_PROMPT * S_PROMPT, D_MODEL), True),
                         ((S_LONG, D_MODEL), True)]:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device="cuda").to(dt)
            s = (torch.randn(shape[-1:], generator=g, device="cuda")
                 * 0.1).to(dt)
            tol = 1e-5 if dt == torch.float32 else 3e-2
            want = rn.rmsnorm_plain(x, s)
            x2 = x.reshape(-1, shape[-1])
            rows, D = x2.shape
            plan_errs = {p.name: max_err(rn.launch(x2, s, 1e-6, p)
                                         .reshape(shape), want, tol)
                         for p in (rn.rows_plan(rows, D, x.element_size()),
                                   rn.ring_plan(rows, D, x.element_size(),
                                                n_sm))}
            rec = dict(kernel="rmsnorm", shape=list(shape), dtype=str(dt),
                       plan=rn.plan(rows, D, dt, n_sm).name,
                       max_abs_err=max_err(rn.rmsnorm(x, s), want, tol),
                       plan_max_abs_err=plan_errs, tol=tol)
            if timed:
                n = x.numel()
                w = (1.0 + s.float()).to(dt)
                rec["ms"] = time_ms(lambda: rn.rmsnorm(x, s), 50, flush)
                rec["plain_ms"] = time_ms(lambda: rn.rmsnorm_plain(x, s), 50,
                                          flush)
                rec["library_ms"] = time_ms(
                    lambda: F.rms_norm(x, (shape[-1],), w, 1e-6), 50, flush)
                # host cost of one call, as a forward or decode step's 97
                # norms pay it
                rec["host_us"] = host_us(lambda: rn.rmsnorm(x, s), N_NORMS)
                rec["library_host_us"] = host_us(
                    lambda: F.rms_norm(x, (shape[-1],), w, 1e-6), N_NORMS)
                rec["bound_ms"], rec["bound_by"] = bound(
                    2 * n * x.element_size() + s.numel() * s.element_size(),
                    4 * n, torch.float32)
                rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            records.append(rec)
            print(f"[K1 rmsnorm] {json.dumps(rec)}")
            del x, want
    # the launch floor: the library's empty kernel on the decode call's
    # grid, timed as the kernels are
    p = rn.plan(B_PROMPT, D_MODEL, torch.bfloat16, n_sm)
    x = torch.empty((B_PROMPT, D_MODEL), dtype=torch.bfloat16, device="cuda")
    floor = dict(kernel="launch_floor", grid=[p.grid, p.threads],
                 ms=time_ms(lambda: rn.empty_launch(p.grid, p.threads), 50,
                            flush),
                 host_us=host_us(lambda: rn.empty_launch(p.grid, p.threads),
                                 N_NORMS),
                 # the allocation of the output, as the wrapper makes it
                 alloc_host_us=host_us(lambda: torch.empty_like(x), N_NORMS))
    records.append(floor)
    print(f"[K1 floor] {json.dumps(floor)}")
    # where the plans cross: both plans over row counts at yi-9b's width
    for dt in (torch.bfloat16, torch.float32):
        for rows in (1, 4, 16, 64, 132, 264, 528, 792, 1024, 1056, 1057,
                     2048, 4096):
            x = torch.randn((rows, D_MODEL), generator=g,
                            device="cuda").to(dt)
            s = torch.zeros(D_MODEL, dtype=dt, device="cuda")
            rec = dict(rows=rows, D=D_MODEL, dtype=str(dt),
                       picked=rn.plan(rows, D_MODEL, dt, n_sm).name)
            for p in (rn.rows_plan(rows, D_MODEL, x.element_size()),
                      rn.ring_plan(rows, D_MODEL, x.element_size(), n_sm)):
                rec[f"{p.name}_ms"] = time_ms(
                    lambda: rn.launch(x, s, 1e-6, p), 50, flush)
            print(f"[K1 plans] {json.dumps(rec)}")

    # K2 flash attention, both routes (bf16: tensor cores; float32:
    # scalar): the JAX test shapes (KV = H), then yi-9b's (H=32 over KV=4),
    # then gemma3-12b's global layers' (16 over 8, hd 256; bf16 only).
    # fp32: the JAX test's 2e-4 (abs + rel; summation order). bf16: the
    # kernel rounds P to bf16 before P @ V and both it and the plain
    # version round the output to bf16, so an element differs by a few
    # bf16 ulps (2^-8 of itself) at most (worst row ~4e-3 in the CPU
    # emulation, tests/test_torch_kernels.py). An absolute limit would
    # exceed the outputs themselves at long S (a causal row i averages i+1
    # values, std ~(i+1)^-0.5), so each output row (b, s, h) is held by its
    # relative error ||got - want|| / ||want|| <= 1e-2, scaled to its own
    # magnitude.
    both, bf16 = (torch.float32, torch.bfloat16), (torch.bfloat16,)
    for (B, S, H, KV, hd), timed, dts in [
            ((1, 128, 2, 2, 64), False, both),
            ((2, 256, 1, 1, 32), False, both),
            ((1, 64, 4, 4, 128), False, both),
            ((4, 256, 32, 4, 128), True, both),
            ((1, 4096, 32, 4, 128), True, both),
            ((1, 2048, 16, 8, 256), True, bf16)]:
        for causal in (True, False):
            for dt in dts:
                q = torch.randn((B, S, H, hd), generator=g,
                                device="cuda").to(dt)
                k = torch.randn((B, S, KV, hd), generator=g,
                                device="cuda").to(dt)
                v = torch.randn((B, S, KV, hd), generator=g,
                                device="cuda").to(dt)
                got = fa.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                want = fa.flash_attention_plain(q, k, v, causal=causal)
                rec = dict(kernel=f"flash_attention_{fa.ROUTES[dt]}",
                           shape=[B, S, H, KV, hd], causal=causal,
                           dtype=str(dt))
                if dt == torch.float32:
                    rec["max_abs_err"] = max_err(got, want, 2e-4)
                    rec["tol"] = 2e-4
                else:
                    rel = row_rel_err(got, want)
                    check(rel <= 1e-2, f"results disagree: worst row "
                          f"relative error {rel} beyond 1e-2")
                    rec["max_abs_err"] = (got.float() - want.float()).abs() \
                        .max().item()
                    rec["row_rel_err"], rec["row_rel_tol"] = rel, 1e-2
                del want
                if timed:
                    it = 5 if S >= 4096 else 20
                    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                    rec["ms"] = time_ms(
                        lambda: fa.flash_attention(q, k, v, causal=causal),
                        it, flush)
                    rec["plain_ms"] = time_ms(
                        lambda: fa.flash_attention_plain(q, k, v,
                                                         causal=causal),
                        it, flush)
                    def sdpa():
                        return F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal, enable_gqa=True)
                    rec["library_ms"] = time_ms(sdpa, it, flush)
                    # host cost of one call, as a forward's 48 layers pay it
                    rec["host_us"] = host_us(
                        lambda: fa.flash_attention(q, k, v, causal=causal))
                    rec["library_host_us"] = host_us(sdpa)
                    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
                    rec["bound_ms"], rec["bound_by"] = bound(
                        q.element_size() * 2 * B * S * hd * (H + KV),
                        4 * hd * pairs, dt)
                    rec["tflops"] = 4 * hd * pairs / rec["ms"] / 1e9
                    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
                records.append(rec)
                print(f"[K2 {rec['kernel']}] {json.dumps(rec)}")
                del q, k, v, got
    return records


def model_check_small():
    """The whole model on the card (kernels) against the same weights on the
    CPU (plain versions), float32, reduced configs, ragged S=40."""
    from repro_torch.models import registry
    from repro_torch.train import serve
    for arch in ("yi-9b", "gemma3-12b"):
        cfg = registry.load_config(arch).reduced()
        cpu = registry.init_params(cfg, seed=0, device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        toks = torch.randint(0, cfg.vocab, (2, 40),
                             generator=torch.Generator().manual_seed(1))
        want = serve.prefill_logits(cpu, {"tokens": toks})
        got = serve.prefill_logits(gpu, {"tokens": toks.cuda()}).cpu()
        # fp32 on both sides; only summation orders differ
        err = max_err(got, want, 1e-4)
        print(f"[model check] {arch} reduced, fp32, card vs CPU: "
              f"max abs err {err:.3g} (tol 1e-4)")


def phase2():
    from repro_torch.kernels import ops, rmsnorm as rn
    from repro_torch.models import registry
    from repro_torch.train import serve
    cfg = registry.load_config("yi-9b")
    t = time.perf_counter()
    model = registry.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {registry.n_params(cfg):,} params, {cfg.dtype}; "
          f"init {time.perf_counter() - t:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B_PROMPT, S_PROMPT), generator=g,
                            device="cuda")
    long_prompt = torch.randint(0, cfg.vocab, (1, S_LONG), generator=g,
                                device="cuda")
    torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    ops.reset_launch_counts()
    # --- the main path: every launch from here to the read is counted ---
    logits, _ = timed(lambda: serve.prefill_logits(model, {"tokens": prompts}))
    per_prefill = ops.launch_counts()
    logits, t_pre = timed(lambda: serve.prefill_logits(model,
                                                       {"tokens": prompts}))
    long_logits, t_long = timed(lambda: serve.prefill_logits(
        model, {"tokens": long_prompt}))
    (cache, seq_logits), t_seq = timed(lambda: serve.sequential_prefill(
        model, prompts, max_seq=S_PROMPT + N_DECODE))
    last = seq_logits[:, -1].argmax(-1, keepdim=True)
    (cache, toks), t_dec = timed(lambda: serve.decode_tokens(
        model, cache, last, S_PROMPT, N_DECODE))
    counts = ops.launch_counts()
    row_launches = dict(rn.rmsnorm.row_launches)
    # --------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(logits.shape == (B_PROMPT, S_PROMPT, cfg.vocab), "prefill shape")
    check(long_logits.shape == (1, S_LONG, cfg.vocab), "long prefill shape")
    check(seq_logits.shape == logits.shape, "sequential prefill shape")
    for name, t in (("prefill", logits), ("long prefill", long_logits),
                    ("sequential prefill", seq_logits)):
        check(bool(torch.isfinite(t).all()), f"{name} logits not finite")
    a, b = seq_logits.float(), logits.float()
    rel_rms = ((a - b).norm() / b.norm()).item()
    top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"[serve] sequential vs parallel prefill logits: rel RMS "
          f"{rel_rms:.4g} (tol {SEQ_VS_PAR_REL_RMS}), max abs "
          f"{(a - b).abs().max().item():.4g}, |logits| max "
          f"{b.abs().max().item():.4g}, top-1 agreement {top1:.4f}")
    check(rel_rms <= SEQ_VS_PAR_REL_RMS,
          "sequential prefill disagrees with parallel prefill")
    check(toks.shape == (B_PROMPT, N_DECODE), "decode shape")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          "decoded token out of range")
    out = dict(
        prefill_tok_s=B_PROMPT * S_PROMPT / t_pre, prefill_s=t_pre,
        long_prefill_tok_s=S_LONG / t_long, long_prefill_s=t_long,
        sequential_prefill_tok_s=B_PROMPT * S_PROMPT / t_seq,
        decode_tok_s=B_PROMPT * N_DECODE / t_dec,
        decode_step_ms=t_dec / N_DECODE * 1e3, peak_mem_gb=peak_gb,
        launches=counts, rmsnorm_launches_by_rows=row_launches,
        launches_per_prefill=per_prefill,
        rel_rms_seq_vs_par=rel_rms, top1_seq_vs_par=top1)
    print(f"[serve] {json.dumps(out)}")
    # RMSNorm: 97 calls a forward or step; 4-row calls in 256 sequential
    # prefill and 32 decode steps, 1024 rows in 2 prefills, 4096 in 1
    want_rows = {B_PROMPT: N_NORMS * (S_PROMPT + N_DECODE),
                 B_PROMPT * S_PROMPT: 2 * N_NORMS, S_LONG: N_NORMS}
    check(counts["rmsnorm"] == sum(want_rows.values()),
          f"rmsnorm launched {counts['rmsnorm']} times, not "
          f"{sum(want_rows.values())}")
    check(row_launches == want_rows,
          f"rmsnorm launches by row count {row_launches} != {want_rows}")
    n_sm = rn.sm_count(0)
    for name in ("rows", "ring"):
        want = sum(n for rows, n in want_rows.items()
                   if rn.plan(rows, D_MODEL, cfg.torch_dtype, n_sm).name
                   == name)
        check(counts[f"rmsnorm_{name}"] == want,
              f"the rmsnorm {name} plan launched "
              f"{counts[f'rmsnorm_{name}']} times, not {want}")
    check(counts["flash_attention_bf16"] == 3 * N_LAYERS,
          f"the bf16 attention route launched "
          f"{counts['flash_attention_bf16']} times, not 3 prefills x "
          f"{N_LAYERS} layers")
    check(counts["flash_attention_fp32"] == 0,
          "the float32 attention route ran on the bf16 main path")
    return counts, row_launches, model, prompts, long_prompt


def phase3(model, prompts, long_prompt):
    """Where the time goes: torch.profiler over one B=4 x 256 prefill, one
    B=1 x 4096 prefill and four B=4 decode steps; device busy share and the
    top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import registry
    from repro_torch.train import serve
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cache = registry.init_cache(model, B_PROMPT, S_PROMPT + 8)
    tok = prompts[:, :1]
    runs = {
        "prefill 4x256": lambda: serve.prefill_logits(model,
                                                      {"tokens": prompts}),
        "prefill 1x4096": lambda: serve.prefill_logits(
            model, {"tokens": long_prompt}),
        "decode 4 steps, B=4": lambda: [registry.decode_step(
            model, cache, tok, i) for i in range(4)],
    }
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        avgs = prof.key_averages()
        kernels = [e for e in avgs if e.device_type != DeviceType.CPU]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        print(f"[profile] {name}: wall {wall_ms:.3f} ms, device busy "
              f"{dev_ms:.3f} ms ({dev_ms / wall_ms:.1%}), kernel launches "
              f"{sum(e.count for e in avgs if 'LaunchKernel' in e.key)}")
        for e in top:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<5d} {e.key[:90]}")
        k1 = [e for e in kernels if "rmsnorm" in e.key]
        k1_ms = sum(e.self_device_time_total for e in k1) / 1e3
        print(f"[profile]   K1 rmsnorm: {k1_ms:.3f} ms over "
              f"{sum(e.count for e in k1)} launches, {k1_ms / dev_ms:.2%} "
              f"of device busy")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    smi = phase0()
    kind = torch.cuda.get_device_name(0)
    peak_key, peaks = peaks_for(kind)
    print(f"peaks: {peak_key} data sheet: {peaks[0] / 1e12} TB/s, "
          f"{peaks[1] / 1e12} TFLOP/s bf16, {peaks[2] / 1e12} TFLOP/s fp32")
    records = phase1(peaks)
    model_check_small()
    counts, row_launches, model, prompts, long_prompt = phase2()
    phase3(model, prompts, long_prompt)

    # each kernel's record at the main path's shapes (the float32 route at
    # the same shape in float32: it is not on the bf16 main path)
    floor = next(r for r in records if r["kernel"] == "launch_floor")
    kernels = []
    for rows in (B_PROMPT, B_PROMPT * S_PROMPT, S_LONG):
        rec = next(r for r in records if r["kernel"] == "rmsnorm"
                   and r["shape"] == [rows, D_MODEL]
                   and r["dtype"] == "torch.bfloat16")
        kernels.append(dict(
            name=f"rmsnorm@{rows}x{D_MODEL}", route="cuda",
            source="src/repro_torch/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:21",
            launches=row_launches[rows], plan=rec["plan"],
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "bound_share", "host_us",
                                    "library_host_us", "shape")},
            floor_ms=floor["ms"], card=smi))
    attn = dict(shape=[B_PROMPT, S_PROMPT, 32, 4, 128], causal=True)
    fa_src = "src/repro/kernels/flash_attention.py:26"
    for name, dt, src in (
            ("flash_attention_bf16", "torch.bfloat16", f"{BF16_LIB}.cu"),
            ("flash_attention_fp32", "torch.float32", "flash_attention.cu")):
        rec = next(r for r in records if r["kernel"] == name
                   and r["dtype"] == dt
                   and all(r.get(k) == v for k, v in attn.items()))
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=fa_src, launches=counts[name],
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "tflops", "bound_share", "host_us",
                                    "library_host_us", "shape")},
            card=smi))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
