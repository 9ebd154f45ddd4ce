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
the most time and RMSNorm's share. Phase 4 drives the verifier's main path
(repro_torch.api.verify on cuda): every registered case at every
registered degree, clean and with each of its bugs, must give its
registered verdict; at degree 2 each clean R_o must equal
tests/golden/suite_degree2.json up to a renaming of t<N> names, and each
clean certificate is replayed numerically on the card (inputs from a
seeded generator, sharded per R_i, G_d evaluated with eval_term, the
outputs rebuilt through R_o) against the sequential fragment run on the
card, at rtol = atol = 2e-4 with TF32 off. It prints one JSON record per
task beside the JAX package's counts from BENCH_verify.json, and checks
that the path launched no kernel (it reaches neither). Phase 5 runs the
verifier's runtime on the card, with CUDA already up in this process:
the time a spawned worker takes to start (interpreter, imports, CUDA
context); the same 58 tasks through repro_torch.api.Suite on 2 and then
4 spawned workers, cache off, each task's stable summary byte-identical
to phase 4's, none degraded to in-process, every worker's task span
traced on cuda with all its kernel launch counts 0, and the traced run
written as a Chrome trace with one track per worker that
`python -m repro_torch.obs report` reads to its top lemma; the
certificate cache cold, warm (all 58 hits) and with its journal's last
line torn (one task proved again); an injected crash (tp_layer@deg2:
error, SIGSEGV, 3 attempts) and hang (pp_stage@deg2, 20 s budget:
timeout) charged to their victims only, each on a pool started after
the chaos variables are set; capture_function on the 11 cases at degree
2 against run_spec, byte for byte; --fn on the port's example in a
subprocess (exit 0, and 1 for the buggy variant); and --explain on a
case bug giving the CPU's failure frontier. It prints each wall time.

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


def phase4_verify():
    """The verifier's main path on the card: the whole case matrix, the
    degree-2 golden and the numeric replay of each clean certificate."""
    from repro_torch import api
    from repro_torch.api.replay import max_rel_excess, replay
    from repro_torch.api.report import same_up_to_renaming
    from repro_torch.kernels import ops
    golden = json.loads((ROOT / "tests/golden/suite_degree2.json").read_text())
    bench = json.loads((ROOT / "BENCH_verify.json").read_text())
    # TF32 would put float32 products beyond the replay's 2e-4
    torch.backends.cuda.matmul.allow_tf32 = False
    tasks = [(case, deg, bug) for case in api.list_strategies()
             for deg in api.get_strategy(case).degrees
             for bug in (None,) + api.get_strategy(case).bug_names()]
    summaries = {}
    ops.reset_launch_counts()
    # --- the verify path: launches from here to the read are counted ---
    t_suite, verify_s = time.perf_counter(), 0.0
    for case, deg, bug in tasks:
        r = api.verify(case, degree=deg, bug=bug, device="cuda")
        verify_s += r.wall_s
        check(r.ok, f"{r.task_id()}: verdict {r.verdict} against the "
              f"expected {r.expected} ({r.error})")
        summaries[r.task_id()] = json.dumps(r.stable_summary(),
                                            sort_keys=True)
        stats = r.stats or {}
        token = api.degree_token(deg)
        jax = bench["fam_scaling"].get(f"{case}_deg{token}") \
            or bench["fig5"].get(f"{case}_deg{token}") \
            or (bench["fig4"].get(case) if token in ("2", "2x2") else None)
        rec = dict(task=r.task_id(), verdict=r.verdict, expected=r.expected,
                   wall_ms=r.wall_s * 1e3,
                   infer_ms=stats["time_s"] * 1e3 if stats else None,
                   egraph_nodes=stats.get("egraph_nodes"),
                   lemma_fires=sum(stats["lemma_fires"].values())
                   if stats else None,
                   gs_ops=stats.get("gs_ops"), gd_ops=stats.get("gd_ops"))
        if r.localization:
            rec["localization"] = {k: r.localization[k] for k in
                                   ("op_index", "op_name", "out_name")}
        if jax and bug is None:
            rec.update({f"jax_{k}": jax[k] for k in (
                "egraph_nodes", "lemma_fires", "gd_ops", "infer_ms")})
        if bug is None and token in ("2", "2x2"):
            g = golden[f"{case}@deg2"]
            check(same_up_to_renaming(r.r_o, g["r_o"]),
                  f"{r.task_id()}: R_o {r.r_o} is not the golden {g['r_o']}")
            t = time.perf_counter()
            got, want = replay(api.build_spec(case, degree=deg,
                                              device="cuda"), "cuda")
            torch.cuda.synchronize()
            rec["replay_ms"] = (time.perf_counter() - t) * 1e3
            rec["replay_excess"] = max_rel_excess(got, want)
            rec["replay_max_abs_err"] = max(
                (got[k].double() - want[k].double()).abs().max().item()
                for k in want)
            check(all(v.device.type == "cuda" for v in got.values()),
                  f"{r.task_id()}: the replay left the card")
            check(rec["replay_excess"] <= 1.0,
                  f"{r.task_id()}: replay beyond rtol = atol = 2e-4")
        print(f"[verify] {json.dumps(rec)}")
    suite_s = time.perf_counter() - t_suite
    counts = ops.launch_counts()
    # --------------------------------------------------------------------
    check(not any(counts.values()),
          f"the verify path launched port kernels: {counts}")
    print(f"[verify] {json.dumps(dict(tasks=len(tasks), suite_s=suite_s,
                                      verify_s=verify_s, launches=counts))}")
    return summaries, verify_s


def _summaries(result):
    return {r.task_id(): json.dumps(r.stable_summary(), sort_keys=True)
            for r in result}


def _check_pooled(result, want, what):
    """Every task of a pooled run as the in-process run gave it, and none
    run by the in-process degradation."""
    got = _summaries(result)
    diff = sorted(k for k in got if got[k] != want.get(k))
    check(not diff, f"{what}: tasks differ from the in-process run: {diff}")
    degraded = [r.task_id() for r in result
                if (r.runtime or {}).get("degraded_reason")]
    check(not degraded, f"{what}: tasks degraded to in-process: {degraded}")


def _worker_spans(tracer):
    return [e for e in tracer.events
            if e.get("name") == "task" and e.get("ph") == "X"
            and e["pid"] != tracer.pid]


def _traced(run):
    """``run()`` under a fresh tracer: its value and the tracer."""
    from repro_torch.obs import trace as obs_trace
    tracer = obs_trace.start("main")
    try:
        return run(), tracer
    finally:
        obs_trace.stop()


def _check_worker_spans(tracer, device, what, cases=True):
    """Every worker ``task`` span of a traced pooled run: the worker's
    device is ``device``, its CUDA state agrees, it launched no kernel
    and, for a case task (``cases``), every capture inside the span made
    its tracing tensors on ``device`` (the ``inputs`` events, which name
    the device of the tensors themselves). Returns the spans."""
    spans = _worker_spans(tracer)
    made = [e for e in tracer.events if e.get("name") == "inputs"
            and e["pid"] != tracer.pid]
    for e in spans:
        a = e["args"]
        check(a["device"] == device
              and a["cuda_initialized"] == (device == "cuda"),
              f"{what}: {a['key']} did not run on the card: {a}")
        check(a["launches"] and not any(a["launches"].values()),
              f"{what}: {a['key']}: its worker launched kernels: "
              f"{a['launches']}")
        if cases:
            on = [i["args"]["device"] for i in made if i["pid"] == e["pid"]
                  and e["ts"] <= i["ts"] <= e["ts"] + e["dur"]]
            check(len(on) >= 2 and all(torch.device(d).type == device
                                       for d in on),
                  f"{what}: {a['key']} traced on {on}, not {device}")
    return spans


def phase5_runtime(inproc, inproc_s, smi, device="cuda"):
    """The verifier's runtime on the card: the suite on spawned workers
    (CUDA already up in this process) against phase 4's in-process run,
    the certificate cache, injected crashes and hangs charged to their
    victims, --fn, tracing and explanations. ``device="cpu"`` rehearses
    it without a card."""
    import contextlib
    import io
    import tempfile
    from repro_torch import api
    from repro_torch.api.functions import run_functions
    from repro_torch.api.suite import _run_task as run_task
    from repro_torch.kernels import ops
    from repro_torch.launch import verify as cli
    from repro_torch.obs import trace as obs_trace
    from repro_torch.runtime import (CertificateCache, RuntimeTask,
                                     SupervisedPool, chaos)
    t_phase = time.perf_counter()
    timings = dict(card=smi, workers0_s=inproc_s)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ops.reset_launch_counts()
    # --- the runtime path: launches from here to the read are counted ---

    # a worker's start-up: the heartbeat manager, then the worker (spawn,
    # imports, CUDA context) and one tiny task; then one case twice on
    # the same worker (the first pays the worker's first capture)
    t = time.perf_counter()
    tracer = obs_trace.start("main")
    try:
        with SupervisedPool(1, device=device) as pool:
            pool._ensure_heartbeats()
            timings["manager_start_s"] = time.perf_counter() - t
            t = time.perf_counter()
            first = pool.execute([RuntimeTask("startup", os.getpid)])
            timings["worker_startup_s"] = time.perf_counter() - t
            for key in ("first_case", "second_case"):
                t = time.perf_counter()
                case = pool.execute([RuntimeTask(
                    key, run_task, (("tp_layer", 2, None), None, device))])
                timings[f"{key}_s"] = time.perf_counter() - t
                check(case[key].ok and json.dumps(
                    api.Report.from_json(case[key].value).stable_summary(),
                    sort_keys=True) == inproc["tp_layer@deg2"],
                      f"{key} on the worker: {case[key]}")
    finally:
        obs_trace.stop()
    check(first["startup"].ok and first["startup"].value != os.getpid(),
          f"startup task: {first['startup']}")
    spans = _worker_spans(tracer)
    timings["worker_startup_split"] = spans[0]["args"]["startup"]
    _check_worker_spans(tracer, device, "start-up", cases=False)
    check(sorted(e["args"]["key"] for e in spans) == [
        "first_case", "second_case", "startup"], "start-up: task spans")

    # the whole matrix, pooled, cache off, traced: 2 workers, then 4
    with api.Suite(include_bugs=True) as s:
        res2, tracer = _traced(lambda: s.run(
            workers=2, timeout_s=300.0, cache=False, device=device))
    _check_pooled(res2, inproc, "workers=2")
    timings["workers2_s"], timings["workers2_pool"] = res2.wall_s, \
        res2.runtime
    spans = _check_worker_spans(tracer, device, "workers=2")
    check(len(spans) == 58 and len({e["pid"] for e in spans}) == 2,
          f"workers=2: {len(spans)} task spans")
    trace_dir = Path(tempfile.mkdtemp(prefix="phase5_"))
    suite4 = api.Suite(include_bugs=True)
    res4, tracer = _traced(lambda: suite4.run(
        workers=4, timeout_s=300.0, cache=False, device=device))
    _check_pooled(res4, inproc, "workers=4")
    timings["workers4_s"], timings["workers4_pool"] = res4.wall_s, \
        res4.runtime
    check(len(res4) == len(inproc) == 58, f"{len(res4)} tasks, not 58")
    spans = _check_worker_spans(tracer, device, "workers=4")
    pids = {e["pid"] for e in spans}
    check(len(spans) == 58 and len(pids) == 4,
          f"{len(spans)} worker task spans from {len(pids)} workers")
    trace_path = trace_dir / "suite4.json"
    tracer.write_chrome(str(trace_path))
    tracer.write_jsonl(str(trace_path) + ".jsonl")
    tracks = {e["pid"] for e in obs_trace.load_events(str(trace_path))
              if e.get("name") == "process_name"}
    check(pids < tracks and tracer.pid in tracks,
          f"trace tracks {sorted(tracks)} lack a worker of {sorted(pids)}")
    rep = subprocess.run([sys.executable, "-m", "repro_torch.obs", "report",
                          str(trace_path)], capture_output=True, text=True,
                         timeout=120, env=env)
    last = rep.stdout.rstrip().splitlines()[-1] if rep.stdout.strip() else ""
    check(rep.returncode == 0 and last.startswith("top lemma: "),
          f"obs report: rc {rep.returncode}, last line {last!r}")
    timings["trace_tracks"], timings["top_lemma"] = len(tracks), last

    # the cache: cold into a fresh directory, warm, then a torn last line
    cache_dir = trace_dir / "cache"
    cold, tracer = _traced(lambda: suite4.run(
        workers=4, timeout_s=300.0, cache=cache_dir, device=device))
    _check_pooled(cold, inproc, "cold cache")
    check((cold.cache["misses"], cold.cache["hits"]) == (58, 0),
          f"cold cache: {cold.cache}")
    check(len(_check_worker_spans(tracer, device, "cold cache")) == 58,
          "cold cache: not every task ran on a worker")
    t = time.perf_counter()
    warm, tracer = _traced(lambda: suite4.run(
        workers=4, timeout_s=300.0, cache=cache_dir, device=device))
    timings["cache_warm_s"] = time.perf_counter() - t
    check(not _worker_spans(tracer), "warm cache: a task ran on a worker")
    suite4.shutdown()
    timings["cache_cold_s"] = cold.wall_s
    _check_pooled(warm, inproc, "warm cache")
    check(warm.cache["hits"] == 58 and all(r.runtime == {"cache": "hit"}
                                           for r in warm),
          f"warm cache: {warm.cache}")
    journal = CertificateCache(cache_dir).journal_path
    raw = Path(journal).read_bytes()
    Path(journal).write_bytes(raw[:-10])
    torn = api.Suite(include_bugs=True).run(workers=0, cache=cache_dir,
                                            device=device)
    _check_pooled(torn, inproc, "torn journal")
    check((torn.cache["misses"], torn.cache["recovered_corrupt"]) == (1, 1),
          f"torn journal: {torn.cache}")

    # chaos: each leg starts its own pool after setting the environment
    # (spawned workers read it when they start); the degree-2 matrix
    # without tp_dp_2d (whose degree-2 id is not one of phase 4's)
    # (each victim's case is put last: once it fails nothing is left to
    # resume, so no replacement pool is spawned for bystanders)
    cases = [c for c in api.list_strategies() if c != "tp_dp_2d"]
    for mode, victim, budget in (("crash", "tp_layer@deg2", 300.0),
                                 ("hang", "pp_stage@deg2", 20.0)):
        order = [c for c in cases if c != victim.split("@")[0]] \
            + [victim.split("@")[0]]
        os.environ[chaos.ENV_SPEC] = f"{mode}:1"
        os.environ[chaos.ENV_TARGET] = victim
        try:
            with api.Suite(cases=order, degrees=(2,)) as s:
                hit, tracer = _traced(lambda: s.run(
                    workers=2, timeout_s=budget, cache=False,
                    device=device))
        finally:
            os.environ.pop(chaos.ENV_SPEC)
            os.environ.pop(chaos.ENV_TARGET)
        by = {r.task_id(): r for r in hit}
        v = by.pop(victim)
        ran = {e["args"]["key"]
               for e in _check_worker_spans(tracer, device, mode)}
        check(set(by) <= ran and victim not in ran,
              f"{mode}: worker spans for {sorted(ran)}")
        if mode == "crash":
            check(v.verdict == "error" and "SIGSEGV" in (v.error or "")
                  and v.runtime.get("attempts") == 3,
                  f"crash victim: {v.verdict} {v.error} {v.runtime}")
        else:
            check(v.verdict == "timeout" and "budget" in (v.error or ""),
                  f"hang victim: {v.verdict} {v.error}")
        rest = api.SuiteResult(list(by.values()), 0.0, 2)
        _check_pooled(rest, inproc, f"{mode} survivors")
        timings[f"{mode}_leg_s"] = hit.wall_s
        print(f"[runtime] {mode}:1 on {victim}: {v.verdict} — {v.error}")
    check(float((torch.ones(4, device=device) * 2).sum()) == 8.0,
          "the card is unusable after the chaos legs")

    # --fn: the generic frontend on the card, against the registry
    for case in api.list_strategies():
        spec = api.build_spec(case, degree=2, device=device)
        want = api.run_spec(spec, device=device).to_json()
        got = run_functions(spec.seq_fn, spec.dist_fn, spec.mesh_axes,
                            spec.in_specs, spec.avals, spec.input_names,
                            device=device).to_json()
        check(json.dumps(got["r_o"], sort_keys=True)
              == json.dumps(want["r_o"], sort_keys=True)
              and all(got["stats"][k] == want["stats"][k]
                      for k in ("egraph_nodes", "gs_ops", "gd_ops",
                                "lemma_fires")),
              f"{case}: capture_function's certificate is not run_spec's")
    # the CLI on the example and its buggy variant, two processes at once
    t = time.perf_counter()
    procs = {target: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.verify", "--fn",
         f"repro_torch.verify_your_own_fn:{target}", "--json",
         "--device", device], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for target in ("make_task", "make_buggy_task")}
    outs = {target: p.communicate(timeout=300) + (p.returncode,)
            for target, p in procs.items()}
    timings["fn_cli_s"] = time.perf_counter() - t
    for target, rc, verdict in (("make_task", 0, "certificate"),
                                ("make_buggy_task", 1, "refinement_error")):
        out, err, code = outs[target]
        check(code == rc, f"--fn {target}: exit {code} ({err[-2000:]})")
        got = json.loads(out)["report"]
        check(got["verdict"] == verdict and (got["r_o"] if rc == 0
                                             else got["localization"]),
              f"--fn {target}: {got['verdict']}")

    # --explain on a case bug: the card's failure frontier is the CPU's
    def explained(device):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                cli.main(["--case", "sp_rope", "--bug", "rope_offset",
                          "--json", "--explain", "--device", device])
            except SystemExit as e:
                check(e.code == 1, f"--explain exit {e.code}")
        return json.loads(out.getvalue())["explanation"]
    on_card, on_cpu = explained(device), explained("cpu")
    check(on_card == on_cpu and on_card["kind"] == "failure_frontier",
          "--explain: the card's frontier is not the CPU's")

    counts = ops.launch_counts()
    # --------------------------------------------------------------------
    check(not any(counts.values()),
          f"the runtime path launched port kernels: {counts}")
    timings["phase5_s"] = time.perf_counter() - t_phase
    timings["launches"] = counts
    print(f"[runtime] {json.dumps(timings)}")


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
    del model
    torch.cuda.empty_cache()
    inproc, inproc_s = phase4_verify()
    phase5_runtime(inproc, inproc_s, smi)

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
