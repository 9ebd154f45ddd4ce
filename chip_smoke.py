#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 prints the card and its power limit, builds the CUDA kernels with
nvcc (sm_90a, one process per source, in parallel), prints ptxas's
registers, shared memory and spills for each kernel, each attention
library's dynamic shared memory by head dim and the RMSNorm ring's at
D=4096 bf16 and D=8192 fp32, the fp32 route's shared memory and
registers at every head dim and block rows its plan can pick (held to
flash_attention.fp32_smem_bytes and to an SM's registers), and the count
of tensor-core instructions in each attention library's SASS, HGMMA
(wgmma) in the bf16 route's and HMMA (mma.sync, 3xTF32) in the fp32
route's, forward and backward, none of which may be 0, and the rate the
card reaches with TF32 mma.sync from registers (the fp32 route's
ceiling); it checks the bf16 backward's shared memory against
flash_attention.backward_smem_bytes. Phase 1 holds
each kernel against its plain PyTorch version on the card, at the JAX
kernel tests' shapes, at yi-9b's own and at gemma3-12b's global layers'
(16 heads over 8, hd 256), at the families' (K2: kimi-k2's 64 heads over
8 at hd 112 in both routes, whisper's encoder of 1500 frames not causal
and its decoder, qwen2-vl's 12 over 2 at 1024 patches + 256 tokens,
gemma3-27b's global layers' 32 over 16 and command-r's 64 over 8 at hd
128, both at 4 x 256 and 1 x 4096; K2 with a causal sliding window at
the windowed layers' long-prefill shapes: gemma3-12b's local 16 over 8
at hd 256 and gemma3-27b's 32 over 16 at hd 128, window 1024, mixtral's
32 over 8 with its window of 4096, recurrentgemma's 10 over 1 at hd 256,
window 2048, and a window of 333 over a ragged S of 1000; K1 in bf16 at
D = 1024, 1536, 2048, 2560, 5376, 7168 and 8192), in float32 and
bfloat16 (RMSNorm: both launch
plans at every shape; attention: two routes, bf16 on wgmma and float32
in 3xTF32 on mma.sync), and times the kernel, the plain version and one PyTorch
library call beside the card's bound, and the host's time to enqueue one
call (97 RMSNorm calls in a row, 48 attention calls, as a forward makes
them); an empty kernel of the port's library, timed the same way, gives
the launch floor under the short calls, and both RMSNorm plans are timed
over row counts, where plan() switches from one to the other; it also
holds the whole model of every family on the card against the same
model on the CPU at a reduced size. Phase 2 serves yi-9b at full width and depth in bfloat16
with random weights from a seed: parallel prefill of 4 x 256 and 1 x 4096
tokens, sequential prefill of the 4 prompts (whose logits must agree with
the parallel prefill's), and 32 greedy decode steps; the kernels' launch
counters must show exactly the launches this path makes: RMSNorm 97 a
forward or step (28,227 in all, by row count and by plan as plan() says),
the bf16 attention route 48 per prefill (144 in all), the float32 route
never. Phase 3 profiles the two prefills and four decode steps
(torch.profiler) and prints the device busy share, the kernels that take
the most time, K1's, K2's and the plain attention path's share (that
path is what cross-attention and explicit positions take), then the
same for one 1 x 4096 prefill of gemma3-12b at full width, whose 40
local layers now reach K2 with their window (48 K2 launches a prefill,
exactly). Phase 6 (run before phase 4, one
model resident at a time) serves the eight other configs at full width
in bfloat16 from seed 0: mamba2-1.3b, recurrentgemma-2b, qwen2-vl-2b
(1024 patch embeddings in front of the text), whisper-medium (1500
encoder frames), mixtral-8x7b cut to 16 of its 32 layers and
kimi-k2-1t-a32b to 1 of its 61 (their bf16 weights exceed the card;
every cut is printed), gemma3-27b and command-r-35b; each gives parallel
prefill of 4 x 256 and 1 x 4096, sequential prefill of the 4 prompts (64
tokens; mamba2 256, its chunk) and 8 greedy decode steps, finite logits
of the right shapes, sequential against parallel logits within
SEQ_VS_PAR_REL_RMS (moe: its dropped share instead, as the capacity drop
makes them differ by design; mamba2 and recurrentgemma, whose bf16 decode
rounds where their prefill does not in the reference too, within
SEQ_VS_PAR_BF16_GAP, and the same weights in float32 within
SEQ_VS_PAR_REL_RMS_FP32) and exactly the launches the path makes
(``expected_launches``: K2 at every self-attention layer of a forward,
windowed or not); the long prefills of the 16-layer mixtral, gemma3-27b
and recurrentgemma are profiled as gemma3-12b's. Every shape and dtype the phase gave a kernel
is recorded, and afterwards each kernel is held against its plain
version at each of them (``check_path_shapes``). Phase 4 drives the verifier's main path
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
Phase 7 (run after phase 5) drives whole-model and train-step
verification on the card (repro_torch.modelcheck / gradcheck on cuda):
check_model for each of the 8 supported models at dp2xtp2, gpt at dp2,
tp2 and dp4 and mixtral-8x7b at tp2 must certify (gpt@dp2xtp2: 14 blocks, 3 obligations),
the wrong_spec bug at layer 3 must fail block [4], check_train for dp,
dp_accum, fsdp and tp_dp_2d at their first degrees and tp_dp_2d at 4x4
must certify and each of the three gradient bugs must fail exactly
["w2"]; every clean obligation's certificate is replayed on the card,
once per distinct obligation (model blocks on inputs at a model's scale,
rtol = atol = 2e-4, TF32 off), the fires of each task are printed beside BENCH_verify.json's and
must equal them where it has the task, the path must launch no kernel,
and gpt@dp2xtp2 on 2 spawned workers must give the in-process stable
summary byte for byte, each worker tracing on the card and launching
nothing. One [modelcheck]/[gradcheck] JSON line per task, then the
phase's wall times.
Phase 8 (run after phase 7) drives serving-path verification on the
card (repro_torch.servecheck on cuda): tp_decode@2, sp_cache@2 and
batched_decode@2x2 must certify with the targets' lemma fires (180,604,
494,601, 5,274; explain steps as BENCH_verify.json's), stale_cache_shard
must fail exactly ['step3'], pos_off_by_one ['step4'] and
cache_gather_wrong_axis must be an unexpected_relation at ['step1'] (one
certificate cache shared by the phase's in-process runs); every clean
obligation is replayed on the card at rtol = atol = 2e-4; the path must
launch no kernel; tp_decode@2 on 2 spawned workers must give the
in-process stable summary byte for byte; and the explain smoke's three
legs (python -m repro_torch.launch.explain_smoke) must pass on the card.
Phase 9 (run after phase 6) trains on the card. First each backward
kernel against its plain version (the closed form): K2's bf16 and fp32
backward at head dims 32, 64, 112, 128 and 256, causal and not, G = H /
KV of 1, 2 and 8, S = 1024 and the ragged 1000, and at the windowed
shapes of phase 1 with their windows (dq, dk and dv each within 1e-2
relative RMS in bf16, 2e-4 in fp32; the saved LSE within 1e-3 and
1e-5; the fp32 backward one device kernel a call, by the profiler in
a process of its own),
K1's in fp32 and bf16 over
widths 128-8192 and 1-8192 rows (dx as the forward's 1e-5 / 3e-2,
dscale 1e-4 / 1e-2). Then gpt at full width and depth (12 x 768, vocab
50257, bf16, seed 0) for 50 steps of 8 x 1024 tokens through
launch.train's step function (step ms, tokens/s, peak memory, the loss
every 10 steps; exactly 25 RMSNorm and 12 bf16 attention launches a
step and, in the backward, 25 RMSNorm and 12 bf16 attention backward
kernel launches; the mean loss of the last 5 steps below the first
step's); the same model's gradients on one batch of 2 x 1024 against
autograd through the plain versions on the card, in float32 (the
attention's float32 route and its backward kernel; loss within 1e-5
relative, every parameter's gradient within 2e-4 relative RMS) and bf16 (loss within 1e-2, gradient norm within 2e-2); yi-9b at
full width, 8 of its 48 layers (AdamW's ~12 bytes a parameter would not
fit 48), 2 steps of 1 x 4096 tokens in bf16 (17 / 8 forward and backward
launches a step), profiled for the share of a step's device time in each
backward kernel by its kernels' names, and its peak memory;
launch.train's own main for 20 steps of the reduced config (float32: 5
RMSNorm and 2 fp32 attention backward launches a step, no bf16
attention backward); then
each kernel at gpt's, yi-9b's and the reduced config's shapes, forward
and backward, against its plain version and the PyTorch call (F.rms_norm,
scaled_dot_product_attention, and their backward) beside its bound.
Phase 10 runs the launch tooling on a DeviceMesh. (a), right after phase
3 on phase 2's model: yi-9b at full width and depth with its parameters
as DTensors on a real (1, 1) ("data", "model") mesh over a one-rank NCCL
group, under use_sharding, for the 4 x 256 and 1 x 4096 prefills; the
logits must equal phase 2's (the max abs difference is printed, expected
0; fails above MESH_REL_RMS relative RMS), with RMSNorm 97 and bf16
attention 48 launches a forward through the kernels' custom ops, and the
sharded and unsharded prefill ms are printed. (b), last: the dry run
(repro_torch.launch.dryrun) on fake CUDA tensors over the fake 256-rank
mesh for DRYRUN_COMBOS (each family and input mode; the JAX package's
skip_reason skips none) and the 512-rank mesh for gpt and yi-9b prefill:
each combo's FLOPs, bytes (an unfused upper bound) and collective bytes a
device, dominant roofline term, GiB a device, fits_hbm and trace seconds,
with no kernel launched and no exception.
Phase 11 (run after phase 4, whose in-process summaries it needs) runs
the JAX repo's user-facing drivers, ported, through the functions their
``main`` calls: the bug suite (repro_torch.verify_bug_suite: every bug
detected, every task's stable summary phase 4's, no kernel launched),
serve_decode with gemma3-12b at full width and depth in bf16 (B=4,
prompt 12, 16 tokens, max_seq 64: finite logits, tokens of (4, 16),
exactly expected_launches' K1 launches and no K2 in the driver's calls,
its sequential prefill within SEQ_VS_PAR_REL_RMS of parallel prefill's;
decode step ms, tokens/s, peak memory) and train_gpt_100m with its
defaults (gpt 12 x 768, bf16, 300 steps of 8 x 256 in 2 microbatches,
a checkpoint: the loss falls, and every step launches exactly K1 and K2
forward and backward twice a layer and K1 twice more for the final
norm; step ms, tokens/s, peak memory, first and last loss).

    python -c "import chip_smoke as c; c.hang_leg_loop(20)"

loops phase 5's hang leg alone (the runtime's lost-span check, one JSON
line a run and the count of runs that lost a bystander's span).

The last line is {"ok": true, "device": {...}}; the line before it is the
kernels' JSON record (K2 at hd 112, at whisper's encoder and at
qwen2-vl's, gemma3-27b's and command-r's shapes carry the launches of
their model's phase-6 path, K2 with a window those of its model's
windowed path (gemma3-12b: phase 3's); the training shapes those of phase
9's; K1 at serve_decode's (4, 3840) rows and each kernel at
train_gpt_100m's (4, 256) microbatch, timed in phases 1 and 9, those of
phase 11's drivers). Any failure raises and exits non-zero, and
the script exits non-zero without a CUDA device. The backward kernels
have entries of their own (ms the kernel's, plain_ms the closed form's,
library_ms the PyTorch call's backward).

    python3 chip_smoke.py --windowed-profiles

profiles only the long prefills of the windowed models (gemma3-12b,
gemma3-27b, recurrentgemma-2b and the 16-layer mixtral) for the plain
attention path's and K2's share of device time, with the package beside
the script: a copy of this file beside another tree's ``src`` measures
that tree.
"""
import contextlib
import copy
import ctypes
import dataclasses
import json
import math
import os
import re
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

# The rate K2's bound is read against, by dtype: bf16 on wgmma; fp32 as
# 3xTF32 (three TF32 products a product, at a third of TF32's dense rate,
# itself half of bf16's): the fastest float32-accurate route of the card.
# ``bound_fma_ms`` keeps the fp32 bound at the scalar FMA rate beside it.
TC_RATE = {torch.bfloat16: torch.bfloat16, torch.float32: "tf32x3"}

B_PROMPT, S_PROMPT, S_LONG, N_DECODE = 4, 256, 4096, 32
N_LAYERS = 48                          # yi-9b
N_NORMS = 2 * N_LAYERS + 1             # RMSNorm calls a forward or step makes
D_MODEL = 4096                         # yi-9b
BF16_LIB = "flash_attention_sm90"      # csrc/ source of the bf16 route
BF16_BWD_LIB = "flash_attention_bwd_sm90"  # and of its backward
FP32_LIB = "flash_attention"               # the fp32 route (3xTF32)
FP32_BWD_LIB = "flash_attention_bwd"       # and its backward
# Sequential (decode-path) vs parallel (prefill-path) logits in bf16: the
# two paths round at different places (the flash kernel's tiled online
# softmax vs the decode attention's one pass, GEMM vs GEMV summation order)
# and the error compounds over 48 residual layers. bf16's unit roundoff is 2^-8 = 3.9e-3;
# allow ~13 of it in relative RMS over all logits.
SEQ_VS_PAR_REL_RMS = 5e-2
# Families whose bf16 decode rounds where their prefill does not, in the
# JAX package itself: mamba2 reads its fp32 state out in bf16 and forms
# its update in bf16, where prefill's SSD stays in fp32 to out_proj;
# recurrentgemma's decode state is fp32 where prefill's scan is bf16. The
# bf16 gap grows with depth (the JAX package's own at 12 reduced layers
# is held beside the port's by tests/test_torch_families_bf16.py). So for
# these the two paths are held in float32 (the same weights, TF32 off)
# within SEQ_VS_PAR_REL_RMS_FP32, and the bf16 gap within 1.5x of this
# phase's own reading at full depth (seed 0, H100 80GB HBM3: mamba2
# 0.3629 at 48 layers, recurrentgemma 0.06077 at 26; the same in two runs
# of the final kernels), so that a fault of the bf16 path alone (a cast
# in decode, the fp32 state read back) still fails.
ROUNDS_APART = ("ssm", "hybrid")
SEQ_VS_PAR_REL_RMS_FP32 = 1e-3
SEQ_VS_PAR_BF16_GAP = {"mamba2-1.3b": 1.5 * 0.3629,
                       "recurrentgemma-2b": 1.5 * 0.06077}

# Phase 10: the sharded yi-9b's logits against the unsharded ones (the same
# kernels on the same data: expected equal; bf16's 2^-8 with headroom) and
# the dry run's combos (arch, input shape, multi-pod): each family and mode
DRYRUN_COMBOS = (
    ("yi-9b", "train_4k", False), ("yi-9b", "prefill_32k", False),
    ("yi-9b", "decode_32k", False), ("gemma3-12b", "decode_32k", False),
    ("gemma3-12b", "long_500k", False), ("mixtral-8x7b", "decode_32k", False),
    ("kimi-k2-1t-a32b", "prefill_32k", False),
    ("mamba2-1.3b", "prefill_32k", False), ("mamba2-1.3b", "long_500k", False),
    ("recurrentgemma-2b", "prefill_32k", False),
    ("recurrentgemma-2b", "long_500k", False),
    ("qwen2-vl-2b", "prefill_32k", False), ("whisper-medium", "decode_32k", False),
    ("command-r-35b", "decode_32k", False), ("gemma3-27b", "decode_32k", False),
    ("gpt", "prefill_32k", True), ("yi-9b", "prefill_32k", True))
MESH_REL_RMS = 1e-2

# The families (phase 6) and their kernel shapes (phase 1)
FAMILY_ARCHS = ("mixtral-8x7b", "kimi-k2-1t-a32b", "mamba2-1.3b",
                "recurrentgemma-2b", "qwen2-vl-2b", "whisper-medium")
SERVED = ("mamba2-1.3b", "recurrentgemma-2b", "qwen2-vl-2b",
          "whisper-medium", "mixtral-8x7b", "kimi-k2-1t-a32b", "gemma3-27b",
          "command-r-35b")
# bf16 weights that do not fit the card's 80 GB: mixtral-8x7b 93.4 GB
# (16 layers ~47 GB), kimi-k2 34 GB of experts a layer (1 layer + 4.7 GB of
# embeddings); every other model runs at full depth if it fits
DEPTH_CUTS = {"mixtral-8x7b": 16, "kimi-k2-1t-a32b": 1}
HEADROOM = 10e9               # bytes left for activations beside the weights
SEQ_STEPS = 64                # sequential-prefill tokens (mamba2: S_PROMPT)
N_FAMILY_DECODE = 8
FAMILY_WIDTHS = (1024, 1536, 2048, 2560, 5376, 7168, 8192)
GEMMA12_D = 3840              # gemma3-12b: K1 at serve_decode's 4 rows
KIMI_ATTN = (1, S_LONG, 64, 8, 112)
WHISPER_ENC_ATTN = (B_PROMPT, 1500, 16, 16, 64)
WHISPER_DEC_ATTN = (B_PROMPT, S_PROMPT, 16, 16, 64)
QWEN_ATTN = (B_PROMPT, 1024 + S_PROMPT, 12, 2, 128)
GEMMA27_ATTN = [(B, S, 32, 16, 128) for B, S in ((B_PROMPT, S_PROMPT),
                                                 (1, S_LONG))]
CMDR_ATTN = [(B, S, 64, 8, 128) for B, S in ((B_PROMPT, S_PROMPT),
                                             (1, S_LONG))]
# K2 with a causal sliding window at the windowed families' long-prefill
# shapes (tag, (B, S, H, KV, hd), window, dtypes, timed): gemma3-12b's and
# gemma3-27b's local layers, mixtral's (its window of 4096 is S: the causal
# mask alone), recurrentgemma's local layers, and a window that is no tile
# multiple over a ragged S
WINDOW_ATTN = (
    ("gemma3_12b_local", (1, S_LONG, 16, 8, 256), 1024,
     (torch.bfloat16, torch.float32), True),
    ("gemma3_27b_local", (1, S_LONG, 32, 16, 128), 1024, (torch.bfloat16,),
     True),
    ("mixtral", (1, S_LONG, 32, 8, 128), 4096, (torch.bfloat16,), True),
    ("recurrentgemma_local", (1, S_LONG, 10, 1, 256), 2048,
     (torch.bfloat16,), True),
    ("ragged", (2, 1000, 8, 2, 128), 333, (torch.bfloat16, torch.float32),
     False))
# the windowed models whose long prefill is profiled for the plain
# attention path's share (phase 3: gemma3-12b; phase 6: the others)
WINDOWED_ARCHS = ("gemma3-12b", "gemma3-27b", "recurrentgemma-2b",
                  "mixtral-8x7b")


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
        if name == BF16_LIB:
            smem_bytes = getattr(ctypes.CDLL(str(path)),
                                 f"repro_{name}_smem_bytes")
            smem_bytes.argtypes = [ctypes.c_int]
            smem_bytes.restype = ctypes.c_int
            smem = {hd: smem_bytes(hd) for hd in (32, 64, 112, 128, 256)}
            print(f"[smem] {name}: dynamic shared memory a block, by head "
                  f"dim: {smem}")
        elif name == "rmsnorm":
            for D, dt in ((4096, torch.bfloat16), (8192, torch.float32)):
                p = rn.plan(S_LONG, D, dt, n_sm)
                print(f"[smem] rmsnorm: {p.name} plan at D={D} {dt}, "
                      f"{n_sm} SMs: {p.stages} stages of {D * dt.itemsize} "
                      f"bytes, {p.smem} bytes of dynamic shared memory a "
                      f"block, grid {p.grid} x {p.threads} threads")
    from repro_torch.kernels import flash_attention as fa
    fp32_plan_check(libs)
    # tensor-core instructions in each attention library: wgmma (HGMMA)
    # in the bf16 route's, mma.sync (HMMA, 3xTF32) in the fp32 route's
    for name, op in ((BF16_LIB, "HGMMA"), (BF16_BWD_LIB, "HGMMA"),
                     (FP32_LIB, "HMMA"), (FP32_BWD_LIB, "HMMA")):
        sass = subprocess.run([cuobjdump(), "-sass", str(libs[name])],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        n = sum(op in ln for ln in sass.splitlines())
        print(f"[sass] {libs[name].name}: {n} {op} instructions")
        check(n > 0, f"{name} has no {op} instruction")
    rate = fa.tf32_mma_rate()
    print(f"[tf32] mma.sync.m16n8k8 TF32 from registers: {rate:.1f} TFLOP/s "
          f"(3xTF32: {rate / 3:.1f}), the fp32 route's ceiling on {smi}")
    smem_bytes = ctypes.CDLL(str(libs[BF16_BWD_LIB])) \
        .repro_flash_attention_bwd_sm90_smem_bytes
    smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    for dq in (0, 1):
        smem = {hd: smem_bytes(hd, dq) for hd in fa.SUPPORTED_HEAD_DIMS}
        print(f"[smem] {BF16_BWD_LIB} {'dQ' if dq else 'main'} kernel: "
              f"dynamic shared memory a block, by head dim: {smem}")
        check(smem == {hd: fa.backward_smem_bytes(hd, bool(dq))
                       for hd in fa.SUPPORTED_HEAD_DIMS},
              f"backward smem {smem} is not backward_smem_bytes'")
    return smi


# ptxas's lines on one instance of the fp32 kernels: the kernel, its head
# dim and block rows from the mangled name, then its registers and spills
_PTXAS_ENTRY = re.compile(r"Compiling entry function '\S*?"
                          r"(flash_fwd_fp32|flash_bwd_fp32)ILi(\d+)ELi(\d+)E")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def fp32_instances(name):
    """{(head dim, block rows): (registers, spill store bytes, spill load
    bytes)} of the fp32 kernel instances in library ``name``, from ptxas's
    report."""
    from repro_torch.kernels import build
    out, key, spill = {}, None, (0, 0)
    for ln in build.ptxas_report(name).splitlines():
        m = _PTXAS_ENTRY.search(ln)
        if m:
            key, spill = (int(m.group(2)), int(m.group(3))), (0, 0)
            continue
        m = _PTXAS_SPILL.search(ln)
        if m and key:
            spill = (int(m.group(1)), int(m.group(2)))
        m = _PTXAS_REGS.search(ln)
        if m and key:
            out[key] = (int(m.group(1)), *spill)
            key = None
    return out


def fp32_plan_check(libs):
    """The fp32 route's shared memory and registers at every head dim and
    block rows its plan can pick, printed and held to the plan: the
    library's shared memory equal to ``fp32_smem_bytes``, within a block's,
    and the registers of the plan's threads within an SM's 64K."""
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    for name, backward in ((FP32_LIB, False), (FP32_BWD_LIB, True)):
        entry = ("repro_flash_attention_bwd_smem_bytes" if backward
                 else "repro_flash_attention_smem_bytes")
        smem_bytes = getattr(ctypes.CDLL(str(libs[name])), entry)
        smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        regs = fp32_instances(name)
        rows = {hd: [r for r in fa.FP32_ROWS
                     if not (backward and hd == 256 and r > 32)]
                for hd in fa.SUPPORTED_HEAD_DIMS}
        rec = {}
        for hd, rs in rows.items():
            for r in rs:
                warps = (fa.fp32_col_split(hd, r) if backward else 1) * r // 16
                smem = smem_bytes(hd, r)
                reg, st, ld = regs[(hd, r)]
                rec[f"hd{hd}x{r}"] = dict(smem=smem, threads=32 * warps,
                                         registers=reg, spill_stores=st,
                                         spill_loads=ld)
                check(smem == fa.fp32_smem_bytes(hd, r, backward)
                      and smem <= rn.SMEM_LIMIT,
                      f"{name} hd {hd} rows {r}: shared memory {smem} is "
                      f"not fp32_smem_bytes' "
                      f"{fa.fp32_smem_bytes(hd, r, backward)}")
                check(reg * 32 * warps <= 65536,
                      f"{name} hd {hd} rows {r}: {reg} registers x "
                      f"{32 * warps} threads beyond an SM's")
        print(f"[fp32-plan] {name}: {json.dumps(rec)}")


def k2_record(shape, causal, window, dt, timed, g, flush, bound, tag=None):
    """K2 (the route of ``dt``) at ``shape`` = (B, S, H, KV, hd), causal or
    not, with a causal sliding window of ``window`` keys (0: none), against
    its plain version: fp32 within the JAX test's 2e-4 (abs + rel; sum
    order); bf16 each output row (b, s, h) within 1e-2 relative error
    ||got - want|| / ||want||, as the kernel rounds P to bf16 before P @ V
    and both sides round the output to bf16 (an absolute limit would exceed
    the outputs themselves at long S: a causal row i averages i+1 values).
    ``timed``: the kernel, the plain version and SDPA (with the boolean
    window mask where there is a window: SDPA's flash backend takes none)
    by CUDA events, the host's time to enqueue one call (48 in a row, as a
    forward's layers), and the bound over the pairs the mask lets
    through."""
    from repro_torch.kernels import flash_attention as fa, ops
    B, S, H, KV, hd = shape
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dt)
    k = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dt)
    v = torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dt)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    rec = dict(kernel=f"flash_attention_{fa.ROUTES[dt]}",
               shape=[B, S, H, KV, hd], causal=causal, dtype=str(dt))
    if window:
        rec.update(window=window, tag=tag)
    if dt == torch.float32:
        rec["max_abs_err"] = max_err(got, want, 2e-4)
        rec["tol"] = 2e-4
    else:
        rel = row_rel_err(got, want)
        check(rel <= 1e-2, f"results disagree: worst row relative error "
              f"{rel} beyond 1e-2 at {rec}")
        rec["max_abs_err"] = (got.float() - want.float()).abs().max().item()
        rec["row_rel_err"], rec["row_rel_tol"] = rel, 1e-2
    del want
    if timed:
        it = 5 if S >= 4096 else 20
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = fa.key_mask(S, S, causal, window, q.device) if window \
            else None
        rec["ms"] = time_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window), it, flush)
        rec["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, window=window), it, flush)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and not window,
                enable_gqa=True)
        rec["library_ms"] = time_ms(sdpa, it, flush)
        rec["host_us"] = host_us(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window))
        rec["library_host_us"] = host_us(sdpa)
        pairs = B * H * ops.attention_pairs(S, S, causal, window)
        rec["pairs"] = pairs
        nbytes = q.element_size() * 2 * B * S * hd * (H + KV)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * hd * pairs,
                                                 TC_RATE[dt])
        if dt == torch.float32:
            rec["bound_fma_ms"] = bound(nbytes, 4 * hd * pairs, dt)[0]
        rec["tflops"] = 4 * hd * pairs / rec["ms"] / 1e9
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    print(f"[K2 {rec['kernel']}] {json.dumps(rec)}")
    return rec


def phase1(peaks):
    from repro_torch.kernels import rmsnorm as rn
    bw, bf16_rate, f32_rate = peaks
    rate = {torch.bfloat16: bf16_rate, torch.float32: f32_rate,
            "tf32x3": bf16_rate / 6}
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
    # Then the families' widths (whisper 1024, qwen2-vl 1536, mamba2 2048,
    # recurrentgemma 2560, gemma3-27b 5376, kimi-k2 7168, command-r 8192)
    # in bf16 at decode's 4 rows and long prefill's 4096.
    n_sm = rn.sm_count(0)
    both = (torch.float32, torch.bfloat16)
    for shape, timed, dts in [((4, 128), False, both),
                              ((2, 16, 256), False, both),
                              ((1, 7, 384), False, both),
                              ((3, 5, 8, 128), False, both),
                              ((B_PROMPT, D_MODEL), True, both),
                              ((B_PROMPT * S_PROMPT, D_MODEL), True, both),
                              ((S_LONG, D_MODEL), True, both)] + [
            ((rows, D), True, (torch.bfloat16,)) for D in FAMILY_WIDTHS
            for rows in (B_PROMPT, S_LONG)] + [
            ((B_PROMPT, GEMMA12_D), True, (torch.bfloat16,))]:
        for dt in dts:
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
    # then gemma3-12b's global layers' (16 over 8, hd 256; bf16 only), then
    # the families' shapes as their main path runs them: kimi-k2's global
    # layers (64 over 8, hd 112, on the hd-128 tile; both routes), whisper's
    # encoder (16 heads, 1500 frames, not causal) and decoder
    # self-attention, qwen2-vl's (12 over 2, 1024 patches + 256 text), and
    # gemma3-27b's (32 over 16) and command-r's (64 over 8) global layers
    # at 4 x 256 and 1 x 4096; then the windowed layers (WINDOW_ATTN). The
    # limits are k2_record's (the bf16 worst row ~4e-3 in the CPU
    # emulation, tests/test_torch_kernels.py).
    bf16 = (torch.bfloat16,)
    tf, t, f = (True, False), (True,), (False,)
    for shape, timed, dts, causals in [
            ((1, 128, 2, 2, 64), False, both, tf),
            ((2, 256, 1, 1, 32), False, both, tf),
            ((1, 64, 4, 4, 128), False, both, tf),
            ((4, 256, 32, 4, 128), True, both, tf),
            ((1, 4096, 32, 4, 128), True, both, tf),
            ((1, 2048, 16, 8, 256), True, bf16, tf),
            (KIMI_ATTN, True, both, t),
            (WHISPER_ENC_ATTN, True, bf16, f),
            (WHISPER_DEC_ATTN, True, bf16, t),
            (QWEN_ATTN, True, bf16, t)] + [
            (shape, True, bf16, t) for shape in GEMMA27_ATTN + CMDR_ATTN]:
        for causal in causals:
            for dt in dts:
                records.append(k2_record(shape, causal, 0, dt, timed, g,
                                         flush, bound))
    # the windowed layers' shapes, each with its window (causal)
    for tag, shape, window, dts, timed in WINDOW_ATTN:
        for dt in dts:
            records.append(k2_record(shape, True, window, dt, timed, g, flush,
                                     bound, tag=tag))
    fp32 = [r for r in records
            if r.get("kernel") == "flash_attention_fp32"]
    print(f"[fp32-worst] K2 fp32 forward at {len(fp32)} shapes: max abs err "
          f"{max(r['max_abs_err'] for r in fp32)} (limit 2e-4 abs + rel)")
    return records


def family_batch(cfg, B, S, g, device="cuda"):
    """tokens (B, S), plus 1024 patch embeddings for the vlm family or the
    encoder's frames for audio, drawn from the generator ``g``."""
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     device=device)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (B, cfg.vision_tokens, cfg.d_model), generator=g,
            device=device).to(cfg.torch_dtype)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(
            (B, cfg.encoder_frames, cfg.d_model), generator=g,
            device=device).to(cfg.torch_dtype)
    return batch


def model_check_small():
    """The whole model on the card (kernels) against the same weights on the
    CPU (plain versions), float32, every family's reduced config, ragged
    S=40 (a multiple of mamba2's reduced chunk)."""
    from repro_torch.models import registry
    from repro_torch.train import serve
    for arch in ("yi-9b", "gemma3-12b") + FAMILY_ARCHS:
        cfg = registry.load_config(arch).reduced()
        cpu = registry.init_params(cfg, seed=0, device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        batch = family_batch(cfg, 2, 40, torch.Generator().manual_seed(1),
                             device="cpu")
        want = serve.prefill_logits(cpu, batch)
        got = serve.prefill_logits(
            gpu, {k: v.cuda() for k, v in batch.items()}).cpu()
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
    return counts, row_launches, model, prompts, long_prompt, \
        (logits, long_logits)


@contextlib.contextmanager
def plain_attention_ranges():
    """Wrap the models' plain attention path (``layers.plain_attention``) in
    a profiler range, so that a trace gives its device time."""
    from torch.profiler import record_function
    from repro_torch.models import layers as L
    real = L.plain_attention

    def ranged(*a, **k):
        with record_function("plain_attention"):
            return real(*a, **k)

    L.plain_attention = ranged
    try:
        yield
    finally:
        L.plain_attention = real


def profile_run(name, fn):
    """torch.profiler over one call of ``fn`` after a warm one: device busy
    share, the top kernels, and K1's, K2's and the plain attention path's
    share of device busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with plain_attention_ranges():
        fn()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type != DeviceType.CPU
               and e.key != "plain_attention"]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"[profile] {name}: wall {wall_ms:.3f} ms, device busy "
          f"{dev_ms:.3f} ms ({dev_ms / wall_ms:.1%}), kernel launches "
          f"{sum(e.count for e in avgs if 'LaunchKernel' in e.key)}")
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")
    out = dict(run=name, wall_ms=wall_ms, device_busy_ms=dev_ms)
    for label, key in (("K1 rmsnorm", "rmsnorm"), ("K2 flash", "flash_fwd")):
        ks = [e for e in kernels if key in e.key]
        ms = sum(e.self_device_time_total for e in ks) / 1e3
        out[f"{key}_ms"] = ms
        print(f"[profile]   {label}: {ms:.3f} ms over "
              f"{sum(e.count for e in ks)} launches, {ms / dev_ms:.2%} "
              f"of device busy")
    # the ranges' device time: the kernels launched inside each range
    ranges = [e for e in prof.events() if e.name == "plain_attention"
              and e.device_type == DeviceType.CPU]
    plain_ms = sum(e.device_time_total for e in ranges) / 1e3
    out["plain_attention_ms"] = plain_ms
    print(f"[profile]   plain attention (windowed, cross or explicit "
          f"positions): {plain_ms:.3f} ms over {len(ranges)} calls, "
          f"{plain_ms / dev_ms:.2%} of device busy")
    return out


def phase3(model, prompts, long_prompt):
    """Where the time goes: torch.profiler over one B=4 x 256 prefill, one
    B=1 x 4096 prefill and four B=4 decode steps; device busy share and the
    top kernels."""
    from repro_torch.models import registry
    from repro_torch.train import serve
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
        profile_run(name, fn)


def windowed_prefill(arch, smi):
    """The plain attention path's and K2's share of a windowed model's long
    prefill: ``arch`` at full width (mixtral cut to DEPTH_CUTS' depth) in
    bf16 from seed 0, one B=1 x 4096 prefill under the profiler
    (``profile_run``: a warm call, then the profiled one), and the kernels'
    launches over both calls (``kernels.ops.launch_counts``)."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import serve
    full = registry.load_config(arch)
    cfg = dataclasses.replace(full, n_layers=DEPTH_CUTS.get(arch,
                                                            full.n_layers))
    model = registry.init_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab, (1, S_LONG), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    ops.reset_launch_counts()
    out = profile_run(f"{arch} ({cfg.n_layers} layers) prefill 1x4096",
                      lambda: serve.prefill_logits(model, {"tokens": tokens}))
    out.update(arch=arch, layers=cfg.n_layers, launches=ops.launch_counts(),
               card=smi)
    print(f"[profile] {json.dumps(out)}")
    del model
    torch.cuda.empty_cache()
    return out


def phase3_windowed(smi):
    """gemma3-12b (40 of its 48 layers local, window 1024; the other
    windowed models are profiled in phase 6): its long prefill's plain
    attention share, which reads ~0 now that the windowed layers reach K2,
    and K2's launches, exactly 48 a prefill."""
    out = windowed_prefill("gemma3-12b", smi)
    check(out["launches"]["flash_attention_bf16"] == 2 * 48,
          f"gemma3-12b: K2 launched {out['launches']} over 2 prefills, "
          f"not 2 x 48")
    check(out["launches"]["flash_attention_fp32"] == 0,
          "gemma3-12b: the float32 attention route ran on the bf16 path")
    return out


def expected_launches(cfg, n_prefills, seq_len, n_decode):
    """The launches the family path makes: (K1, K2's bf16 route).

    K1 takes every RMSNorm: 2 a layer + the final one for a decoder-only
    forward or step (mamba2's norm and out_norm, recurrentgemma's rglru and
    pre_mlp norms included); whisper 3 a decoder layer + 2 an encoder layer
    + enc_norm + final_norm a forward, 3 a layer + 1 a step, and
    sequential prefill encodes the frames once (2 E + 1). K2 takes every
    self-attention layer of a forward, windowed (local) or global
    (recurrentgemma's local ones, none of mamba2), whisper's encoder and decoder
    self-attention, and nothing of a decode step or a cross-attention."""
    L, E = cfg.n_layers, cfg.encoder_layers
    if cfg.family == "audio":
        return (n_prefills * (3 * L + 2 * E + 2) + (seq_len + n_decode)
                * (3 * L + 1) + 2 * E + 1,
                n_prefills * (E + L) + E)
    attn = sum(cfg.pattern[i % len(cfg.pattern)] in ("global", "local")
               for i in range(L))
    return ((n_prefills + seq_len + n_decode) * (2 * L + 1),
            n_prefills * attn)


def serve_family(arch, drops):
    """One model at full width in bf16, random weights from seed 0: two
    warm-up-and-timed B=4 x 256 prefills, one B=1 x 4096 prefill (whisper
    with 1500 frames of the encoder, qwen2-vl with 1024 patch embeddings
    in front of the text), qwen2-vl's text alone once more, sequential
    prefill of the 4 prompts (SEQ_STEPS tokens; mamba2 S_PROMPT, its
    chunk) and N_FAMILY_DECODE greedy decode steps."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import serve
    full = registry.load_config(arch)
    cfg = dataclasses.replace(full, n_layers=DEPTH_CUTS.get(arch,
                                                            full.n_layers))
    nbytes = registry.n_params(cfg) * cfg.torch_dtype.itemsize
    total = torch.cuda.get_device_properties(0).total_memory
    if cfg.n_layers != full.n_layers:
        print(f"[families] {arch}: depth cut {full.n_layers} -> "
              f"{cfg.n_layers} layers ({registry.n_params(full) * 2 / 1e9:.1f}"
              f" GB of bf16 weights at full depth, {nbytes / 1e9:.1f} GB cut;"
              f" the card has {total / 1e9:.1f} GB)")
    check(nbytes + HEADROOM <= total,
          f"{arch}: {nbytes / 1e9:.1f} GB of weights do not fit "
          f"{total / 1e9:.1f} GB with {HEADROOM / 1e9:.0f} GB to spare")
    t = time.perf_counter()
    model = registry.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    g = torch.Generator(device="cuda").manual_seed(1)
    short = family_batch(cfg, B_PROMPT, S_PROMPT, g)
    long = family_batch(cfg, 1, S_LONG, g)
    text = {"tokens": short["tokens"]}
    seq_len = S_PROMPT if cfg.family == "ssm" else SEQ_STEPS
    prompts = short["tokens"][:, :seq_len]
    n_vis = cfg.vision_tokens
    torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    ops.reset_launch_counts()
    # --- the family's main path: launches counted from here to the read ---
    drops["path"] = "prefill"
    serve.prefill_logits(model, short)
    logits, t_pre = timed(lambda: serve.prefill_logits(model, short))
    long_logits, t_long = timed(lambda: serve.prefill_logits(model, long))
    par = serve.prefill_logits(model, text) if n_vis else logits
    drops["path"] = "sequential"
    (cache, seq_logits), t_seq = timed(lambda: serve.sequential_prefill(
        model, prompts, max_seq=seq_len + N_FAMILY_DECODE,
        frames=short.get("frames")))
    last = seq_logits[:, -1].argmax(-1, keepdim=True)
    drops["path"] = "decode"
    (cache, toks), t_dec = timed(lambda: serve.decode_tokens(
        model, cache, last, seq_len, N_FAMILY_DECODE))
    counts = ops.launch_counts()
    # --------------------------------------------------------------------
    drops["path"] = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    V = cfg.vocab
    check(logits.shape == (B_PROMPT, S_PROMPT + n_vis, V),
          f"{arch}: prefill shape {tuple(logits.shape)}")
    check(long_logits.shape == (1, S_LONG + n_vis, V),
          f"{arch}: long prefill shape {tuple(long_logits.shape)}")
    check(par.shape == (B_PROMPT, S_PROMPT, V) and
          seq_logits.shape == (B_PROMPT, seq_len, V),
          f"{arch}: sequential prefill shape {tuple(seq_logits.shape)}")
    check(toks.shape == (B_PROMPT, N_FAMILY_DECODE)
          and int(toks.min()) >= 0 and int(toks.max()) < V,
          f"{arch}: decoded tokens {tuple(toks.shape)} out of range")
    for name, t_ in (("prefill", logits), ("long prefill", long_logits),
                     ("text prefill", par), ("sequential prefill",
                                             seq_logits)):
        check(bool(torch.isfinite(t_).all()), f"{arch}: {name} not finite")
    a, b = seq_logits.float(), par[:, :seq_len].float()
    rel_rms = ((a - b).norm() / b.norm()).item()
    top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    n_prefills = 4 if n_vis else 3
    want_k1, want_k2 = expected_launches(cfg, n_prefills, seq_len,
                                         N_FAMILY_DECODE)
    out = dict(
        arch=arch, layers=cfg.n_layers, full_layers=full.n_layers,
        params=registry.n_params(cfg), init_s=init_s,
        prefill_s=t_pre, prefill_tok_s=B_PROMPT * (S_PROMPT + n_vis) / t_pre,
        long_prefill_s=t_long,
        long_prefill_tok_s=(S_LONG + n_vis) / t_long,
        sequential_tokens=seq_len,
        sequential_prefill_tok_s=B_PROMPT * seq_len / t_seq,
        decode_step_ms=t_dec / N_FAMILY_DECODE * 1e3,
        decode_tok_s=B_PROMPT * N_FAMILY_DECODE / t_dec, peak_mem_gb=peak_gb,
        launches=counts, want_rmsnorm=want_k1, want_flash_bf16=want_k2,
        rel_rms_seq_vs_par=rel_rms, top1_seq_vs_par=top1)
    if arch in WINDOWED_ARCHS:   # in bf16, before the fp32 check below
        out["profile"] = profile_run(
            f"{arch} ({cfg.n_layers} layers) prefill 1x4096",
            lambda: serve.prefill_logits(model, long))
    if cfg.family == "moe":
        out["dropped_share"] = {
            path: sum(int(d) for d, _ in v) / sum(n for _, n in v)
            for path, v in drops.items() if path != "path"}
        drops.clear()
        drops["path"] = None
    if cfg.family in ROUNDS_APART:
        model.float()
        model.cfg = dataclasses.replace(cfg, dtype="float32")
        par32 = serve.prefill_logits(model, text)[:, :seq_len]
        _, seq32 = serve.sequential_prefill(model, prompts, max_seq=seq_len)
        out["rel_rms_seq_vs_par_fp32"] = \
            ((seq32 - par32).norm() / par32.norm()).item()
        del par32, seq32
    print(f"[families] {json.dumps(out)}")
    if cfg.family in ROUNDS_APART:
        check(out["rel_rms_seq_vs_par_fp32"] <= SEQ_VS_PAR_REL_RMS_FP32,
              f"{arch}: float32 sequential prefill disagrees with parallel "
              f"prefill (rel RMS {out['rel_rms_seq_vs_par_fp32']:.4g} > "
              f"{SEQ_VS_PAR_REL_RMS_FP32})")
        check(rel_rms <= SEQ_VS_PAR_BF16_GAP[arch],
              f"{arch}: bf16 sequential prefill disagrees with parallel "
              f"prefill (rel RMS {rel_rms:.4g} > "
              f"{SEQ_VS_PAR_BF16_GAP[arch]:.4g})")
    elif cfg.family != "moe":
        check(rel_rms <= SEQ_VS_PAR_REL_RMS,
              f"{arch}: sequential prefill disagrees with parallel prefill "
              f"(rel RMS {rel_rms:.4g} > {SEQ_VS_PAR_REL_RMS})")
    check(counts["rmsnorm"] == want_k1,
          f"{arch}: rmsnorm launched {counts['rmsnorm']} times, not {want_k1}")
    check(counts["flash_attention_bf16"] == want_k2,
          f"{arch}: the bf16 attention route launched "
          f"{counts['flash_attention_bf16']} times, not {want_k2}")
    check(counts["flash_attention_fp32"] == 0,
          f"{arch}: the float32 attention route ran on the bf16 path")
    del model, cache, logits, long_logits, par, seq_logits
    torch.cuda.empty_cache()
    return out


def phase6_families():
    """Every newly ported config at full width in bf16, one model resident
    at a time (``serve_family``); the capacity drops of the moe models are
    recorded by wrapping ``moe.route`` (no kernel of the port), and the
    shapes the path gives each kernel by wrapping the dispatch in
    ``kernels.ops`` (the kernels' wrappers, which count, are untouched).
    Then each kernel is held against its plain version at every one of
    those shapes (``check_path_shapes``)."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    t_phase = time.perf_counter()
    drops = {"path": None}
    seen = set()
    real_route, real_norm, real_fa = moe.route, ops.rmsnorm, ops.flash_attention

    def route(router, cfg, xt):
        r = real_route(router, cfg, xt)
        if drops["path"] is not None:
            drops.setdefault(drops["path"], []).append(
                ((~r["keep"]).sum(), r["keep"].numel()))
        return r

    def rmsnorm(x, scale, eps=1e-6):
        seen.add(("rmsnorm", (x.numel() // x.shape[-1], x.shape[-1]),
                  x.dtype, eps))
        return real_norm(x, scale, eps)

    def flash_attention(q, k, v, *, causal=True, window=0):
        seen.add(("flash_attention", tuple(q.shape[:3]) + (k.shape[2],
                                                           q.shape[3]),
                  q.dtype, (causal, window)))
        return real_fa(q, k, v, causal=causal, window=window)

    moe.route, ops.rmsnorm, ops.flash_attention = route, rmsnorm, \
        flash_attention
    results, failures = {}, []
    try:
        for arch in SERVED:
            try:
                results[arch] = serve_family(arch, drops)
            except RuntimeError as e:   # a failed check: the next model runs
                failures.append(str(e))
            torch.cuda.empty_cache()
    finally:
        moe.route, ops.rmsnorm, ops.flash_attention = real_route, \
            real_norm, real_fa
    wall = time.perf_counter() - t_phase
    print(f"[families] phase 6 wall {wall:.1f} s")
    check(not failures, "; ".join(failures))
    check_path_shapes(seen)
    return results


def check_path_shapes(seen):
    """Each kernel against its plain version at every (shape, dtype, eps or
    (causal, window)) that phase 6 gave it, on inputs from a seeded generator, with
    phase 1's tolerances: K1 1e-5 (fp32) or 3e-2 (one bf16 output ulp)
    absolute; K2 fp32 2e-4 absolute + relative, bf16 the worst output
    row's relative error within 1e-2."""
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for kind, shape, dt, arg in sorted(seen, key=str):
        if kind == "rmsnorm":
            x = torch.randn(shape, generator=g, device="cuda").to(dt)
            s = (torch.randn(shape[-1:], generator=g, device="cuda")
                 * 0.1).to(dt)
            tol = 1e-5 if dt == torch.float32 else 3e-2
            err = max_err(rn.rmsnorm(x, s, arg), rn.rmsnorm_plain(x, s, arg),
                          tol)
            del x, s
        else:
            B, S, H, KV, hd = shape
            q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dt)
            k, v = (torch.randn((B, S, KV, hd), generator=g,
                                device="cuda").to(dt) for _ in range(2))
            got = fa.flash_attention(q, k, v, causal=arg[0], window=arg[1])
            want = fa.flash_attention_plain(q, k, v, causal=arg[0],
                                            window=arg[1])
            if dt == torch.float32:
                tol, err = 2e-4, max_err(got, want, 2e-4)
            else:
                tol, err = 1e-2, row_rel_err(got, want)
                check(err <= tol, f"{kind} {shape} (causal, window)={arg}: "
                      f"worst row relative error {err} beyond {tol}")
            del q, k, v, got, want
        key = f"{kind} {dt}"
        worst[key] = max(worst.get(key, 0.0), err)
        rec = dict(kernel=kind, shape=shape, dtype=str(dt), arg=arg, err=err,
                   tol=tol)
        print(f"[path shapes] {json.dumps(rec)}")
    torch.cuda.empty_cache()
    print(f"[path shapes] {len(seen)} shapes held, worst {json.dumps(worst)}"
          f" in {time.perf_counter() - t0:.1f} s")


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


def phase11_drivers(inproc, smi):
    """The JAX repo's user-facing drivers, ported, on the card through the
    functions their ``main`` calls: (a) the bug suite, every bug detected
    and every task's stable summary (verdict, R_o, localization) phase
    4's; (b) serve_decode with gemma3-12b at full width and depth in bf16
    (B=4, prompt 12, 16 tokens, max_seq 64): finite logits, tokens of
    (4, 16), exactly ``expected_launches``' K1 launches and no K2 in the
    driver's calls, its sequential prefill's logits within
    SEQ_VS_PAR_REL_RMS of parallel prefill's, decode step ms, tokens/s
    and peak memory; (c) train_gpt_100m with its defaults (gpt 12 x 768,
    bf16, 300 steps of 8 x 256, 2 microbatches, a checkpoint): the loss
    falls, and every step launches exactly K1 and K2's forward and
    backward kernels twice a layer (and the final norm twice); step ms,
    tokens/s, peak memory, first and last loss."""
    import inspect
    import tempfile
    from repro_torch import api
    from repro_torch import serve_decode as sd, train_gpt_100m as tg
    from repro_torch import verify_bug_suite as vbs
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import serve
    out = dict(card=smi)
    t_phase = time.perf_counter()

    # (a) the bug suite
    ops.reset_launch_counts()
    t = time.perf_counter()
    res = vbs.run_bug_suite("cuda")
    out["bug_suite_s"] = time.perf_counter() - t
    counts = ops.launch_counts()
    lines = [line for line in map(vbs.status, res) if line is not None]
    for line in lines:
        print(f"[drivers] {line}")
    check(res.ok and lines and not any("NOT DETECTED" in x for x in lines),
          f"bug suite: {res.summary()}")
    def phase4_id(r):
        # phase 4 names a 2-axis case's degree per axis (tp_dp_2d@deg2x2)
        for deg in api.get_strategy(r.case).degrees:
            n = len(deg) if isinstance(deg, tuple) else 1
            if api.axis_degrees(deg, n) == api.axis_degrees(r.degree, n):
                return api.task_id(r.case, deg, r.bug)
    differ = sorted(r.task_id() for r in res if json.dumps(
        r.stable_summary(), sort_keys=True) != inproc.get(phase4_id(r)))
    check(not differ, f"bug suite: tasks differ from phase 4's: {differ}")
    check(not any(counts.values()), f"the bug suite launched {counts}")
    out["bugs"] = len(lines)
    print("[drivers] bug_suite " + json.dumps(dict(
        bugs=len(lines), tasks=len(res), s=out["bug_suite_s"],
        launches=counts)))

    # (b) serve_decode at full width and depth
    cfg = registry.load_config(sd.ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.dtype) == (48, 3840, "bfloat16"),
          f"gemma3-12b config {cfg}")
    B, S, gen, max_seq = sd.BATCH, sd.PROMPT, sd.GEN, sd.MAX_SEQ
    torch.cuda.reset_peak_memory_stats()
    model = registry.init_params(cfg, 0, "cuda")
    prompt = sd.make_prompt(cfg, B, S, "cuda")
    ops.reset_launch_counts()
    # --- the serve_decode path: launches from here to the read counted ---
    torch.cuda.synchronize()
    t = time.perf_counter()
    served = sd.serve_decode(model, prompt, gen, max_seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    # ----------------------------------------------------------------------
    want_k1, _ = expected_launches(cfg, 0, S, gen)
    check(counts["rmsnorm"] == want_k1 and not counts["flash_attention"]
          and not counts["rmsnorm_bwd"],
          f"serve_decode launched {counts}, not {want_k1} RMSNorm and no "
          f"attention kernel")
    logits, toks = served["logits"], served["tokens"]
    check(logits.shape == (B, S, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"serve_decode logits {tuple(logits.shape)} not finite or shaped")
    check(tuple(toks.shape) == (B, gen) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"tokens {tuple(toks.shape)}")
    # decode alone, timed: 16 more steps from the driver's cache
    torch.cuda.synchronize()
    t = time.perf_counter()
    serve.decode_tokens(model, served["cache"], toks[:, -1:], S + gen, gen)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    par = serve.prefill_logits(model, {"tokens": prompt}).float()
    rel = ((logits.float() - par).norm() / par.norm()).item()
    check(rel <= SEQ_VS_PAR_REL_RMS,
          f"serve_decode: sequential prefill against parallel prefill, rel "
          f"RMS {rel:.4g} > {SEQ_VS_PAR_REL_RMS}")
    out["serve_decode"] = dict(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        dtype=cfg.dtype, batch=B, prompt=S, gen=gen, max_seq=max_seq,
        driver_s=wall, decode_step_ms=decode_s / gen * 1e3,
        tokens_per_s=B * gen / decode_s, rel_rms_seq_vs_par=rel,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
        generated=toks[0].tolist())
    print(f"[drivers] serve_decode {json.dumps(out['serve_decode'])}")
    del model, served, logits, toks, par
    torch.cuda.empty_cache()

    # (c) train_gpt_100m with its defaults
    cfg = registry.load_config("gpt")
    n_mb = tg.TRAIN_CONFIG.microbatches
    per_step = {"rmsnorm": n_mb * (2 * cfg.n_layers + 1),
                "flash_attention_bf16": n_mb * cfg.n_layers,
                "flash_attention_fp32": 0,
                "rmsnorm_bwd": n_mb * (2 * cfg.n_layers + 1),
                "flash_attention_bwd_bf16": n_mb * cfg.n_layers,
                "flash_attention_bwd_fp32": 0}
    launches = dict.fromkeys(per_step, 0)

    def on_step(step, _metrics):
        counts = ops.launch_counts()
        check(all(counts[k] == n for k, n in per_step.items()),
              f"train_gpt_100m step {step}: launches {counts}, a step "
              f"makes {per_step}")
        for k in per_step:
            launches[k] += counts[k]
        ops.reset_launch_counts()

    torch.cuda.reset_peak_memory_stats()
    model = registry.init_params(cfg, 0, "cuda")
    ckpt = tempfile.mkdtemp(prefix="train_gpt_100m_")
    ops.reset_launch_counts()
    # --- the training path: each step's launches counted in on_step -------
    trained = tg.train(model, ckpt=ckpt, on_step=on_step)
    # ----------------------------------------------------------------------
    steps = len(trained["losses"])
    # the driver's defaults: batch and sequence of each step
    defaults = inspect.signature(tg.train).parameters
    batch, seq = defaults["batch"].default, defaults["seq"].default
    check(trained["last"] < trained["first"]
          and all(math.isfinite(x) for x in trained["losses"]),
          f"train_gpt_100m: loss {trained['first']} -> {trained['last']}")
    check(any(Path(ckpt).iterdir()), "train_gpt_100m wrote no checkpoint")
    steady = sorted(trained["step_ms"][5:])[len(trained["step_ms"][5:]) // 2]
    out["train_gpt_100m"] = dict(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        dtype=cfg.dtype, n_params=registry.n_params(cfg), steps=steps,
        batch=[batch, seq], microbatches=n_mb, first_loss=trained["first"],
        last_loss=trained["last"], first_step_ms=trained["step_ms"][0],
        median_step_ms=steady, tokens_per_s=batch * seq / steady * 1e3,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
        per_step=per_step)
    print(f"[drivers] train_gpt_100m {json.dumps(out['train_gpt_100m'])}")
    del model, trained
    torch.cuda.empty_cache()
    out["phase11_s"] = time.perf_counter() - t_phase
    print(f"[drivers] phase11_s {out['phase11_s']}")
    return out


def hang_leg_loop(n=20, device="cuda"):
    """Phase 5's hang leg alone, ``n`` times: the same 10-case degree-2
    order with pp_stage@deg2 last, ``hang:1`` on it, 2 workers, a 20 s
    budget, traced. One ``[hang-loop]`` JSON line a run: the bystanders
    whose worker ``task`` span is missing from the merged trace, with
    their outcomes, the supervisor's ``run`` spans and the fault events,
    and the bystanders whose stable summary differs from an in-process
    run's. Returns the number of runs that lost a span or a summary.

        python -c "import chip_smoke as c; c.hang_leg_loop(20)"
    """
    from repro_torch import api
    from repro_torch.runtime import chaos
    victim = "pp_stage@deg2"
    order = [c for c in api.list_strategies()
             if c not in ("tp_dp_2d", "pp_stage")] + ["pp_stage"]
    want = _summaries(api.Suite(cases=order, degrees=(2,)).run(
        workers=0, device=device))
    bad = 0
    for i in range(n):
        os.environ[chaos.ENV_SPEC] = "hang:1"
        os.environ[chaos.ENV_TARGET] = victim
        try:
            with api.Suite(cases=order, degrees=(2,)) as s:
                hit, tracer = _traced(lambda: s.run(
                    workers=2, timeout_s=20.0, cache=False, device=device))
        finally:
            os.environ.pop(chaos.ENV_SPEC)
            os.environ.pop(chaos.ENV_TARGET)
        by = {r.task_id(): r for r in hit}
        v = by.pop(victim)
        ran = {e["args"]["key"] for e in _worker_spans(tracer)}
        missing = sorted(set(by) - ran)
        got = _summaries(api.SuiteResult(list(by.values()), 0.0, 2))
        differ = sorted(k for k in got if got[k] != want.get(k))
        runs = [(e["args"]["key"], e["args"]["status"],
                 round(e["dur"] / 1e6, 3)) for e in tracer.events
                if e.get("name") == "run" and e.get("ph") == "X"
                and e["args"].get("key") in missing]
        faults = [(e["name"], e["args"].get("key"),
                   e["args"].get("liveness")) for e in tracer.events
                  if e.get("cat") == "fault"]
        bad += bool(missing or differ or victim in ran
                    or v.verdict != "timeout")
        print("[hang-loop] " + json.dumps(dict(
            run=i, wall_s=hit.wall_s, victim=v.verdict, missing=missing,
            outcomes={k: [by[k].verdict, by[k].error, by[k].runtime]
                      for k in missing}, run_spans=runs, differ=differ,
            faults=faults)), flush=True)
    print(f"[hang-loop] {bad} of {n} runs lost a bystander's span or "
          f"summary", flush=True)
    return bad


def _fires(reports):
    return sum(sum(((r.get("stats") or {}).get("lemma_fires") or {})
                   .values()) for r in reports.values())


def phase7_checks(smi, device="cuda"):
    """Whole-model and train-step verification on the card: check_model
    for every supported model at dp2xtp2, gpt at every default plan and
    mixtral-8x7b at tp2,
    the wrong_spec bug at layer 3, check_train for the four strategies
    (tp_dp_2d at 2x2 and 4x4) and the three gradient bugs, every clean
    obligation's certificate replayed, then gpt@dp2xtp2 on two spawned
    workers against the in-process run. ``device="cpu"`` rehearses it
    without a card."""
    from repro_torch.api import degree_token
    from repro_torch.api.replay import max_rel_excess, replay
    from repro_torch.gradcheck import (check_train, get_train_strategy,
                                       list_train_bugs, replay_train)
    from repro_torch.kernels import ops
    from repro_torch.modelcheck import check_model, decompose, \
        supported_models
    from repro_torch.modelcheck.blocks import replay_inputs
    from repro_torch.sharding.specs import DEFAULT_PLANS
    bench = json.loads((ROOT / "BENCH_verify.json").read_text())
    # TF32 would put float32 products beyond the replay's 2e-4
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    # --- the model and train paths: launches from here to the read ---
    model_tasks = [(m, "dp2xtp2") for m in supported_models()] + \
        [("gpt", p) for p in DEFAULT_PLANS if p != "dp2xtp2"] + \
        [("mixtral-8x7b", "tp2")]                 # BENCH's fourth task
    inproc = None
    replayed = {}        # canonical key -> worst excess: models share blocks
    for model, plan in model_tasks:
        t = time.perf_counter()
        r = check_model(model, plan, workers=0, device=device)
        wall_ms = (time.perf_counter() - t) * 1e3
        check(r.ok and r.verdict == "certificate",
              f"{model}@{plan}: {r.verdict} (blocks {r.failing_blocks})")
        if (model, plan) == ("gpt", "dp2xtp2"):
            check((r.total_blocks, r.unique_obligations) == (14, 3),
                  f"gpt@dp2xtp2: {r.total_blocks} blocks, "
                  f"{r.unique_obligations} obligations")
            inproc = r
        dec = decompose(model, plan, device=device)
        t = time.perf_counter()
        keys = dec.obset.keys_in_order()
        for key in keys:
            if key in replayed:       # the same obligation, the same cert
                continue
            ob = dec.obset.unique[key]
            got, want = replay(ob.to_strategy_spec(name=key), device,
                               inputs=replay_inputs(ob, device=device))
            check(all(v.device.type == torch.device(device).type
                      for v in got.values()), f"{key}: the replay left "
                  f"the {device}")
            replayed[key] = max_rel_excess(got, want)
        excess = max(replayed[key] for key in keys)
        check(excess <= 1.0, f"{model}@{plan}: replay beyond rtol = atol "
              f"= 2e-4 ({excess})")
        jax = bench["modelcheck"].get(f"{model}@{plan}", {})
        fires = _fires(r.reports)
        if jax:
            check(fires == jax["lemma_fires"], f"{model}@{plan}: {fires} "
                  f"fires against BENCH's {jax['lemma_fires']}")
        print(f"[modelcheck] {json.dumps(dict(
            task=f'{model}@{plan}', verdict=r.verdict,
            blocks=r.total_blocks, obligations=r.unique_obligations,
            lemma_fires=fires, bench_lemma_fires=jax.get('lemma_fires'),
            wall_ms=wall_ms, infer_ms=r.timing()['infer_s_sum'] * 1e3,
            replay_ms=(time.perf_counter() - t) * 1e3,
            replay_excess=excess))}")
    r = check_model("gpt", "dp2xtp2", bug="wrong_spec", bug_layer=3,
                    workers=0, device=device)
    check(r.ok and r.verdict == "refinement_error"
          and r.failing_blocks == [4],
          f"wrong_spec@layer3: {r.verdict}, blocks {r.failing_blocks}")
    print(f"[modelcheck] {json.dumps(dict(
        task='gpt@dp2xtp2+wrong_spec@layer3', verdict=r.verdict,
        failing_blocks=r.failing_blocks, wall_ms=r.wall_s * 1e3))}")
    train_tasks = [(s, get_train_strategy(s).degrees[0], None)
                   for s in ("dp", "dp_accum", "fsdp", "tp_dp_2d")] + \
        [("tp_dp_2d", (4, 4), None)] + \
        [(host, None, bug) for bug, (host, _) in
         sorted(list_train_bugs().items())]
    for strategy, degree, bug in train_tasks:
        r = check_train(strategy, degree=degree, bug=bug, device=device)
        task = r.task_id()
        rec = dict(task=task, verdict=r.verdict, wall_ms=r.wall_s * 1e3,
                   infer_ms=r.timing()["infer_s_sum"] * 1e3)
        if bug:
            check(r.ok and r.failing_params == ["w2"],
                  f"{task}: {r.verdict}, params {r.failing_params}")
            rec["failing_params"] = r.failing_params
        else:
            check(r.ok and r.verdict == "certificate",
                  f"{task}: {r.verdict} ({r.failing_params})")
            excess = 0.0
            t = time.perf_counter()
            for spec in get_train_strategy(strategy).build(
                    degree=degree).values():
                got, want = replay_train(spec, device)
                excess = max(excess, max_rel_excess(got, want))
            check(excess <= 1.0, f"{task}: replay beyond rtol = atol = "
                  f"2e-4 ({excess})")
            jax = bench["gradcheck"].get(
                f"train@{strategy}@deg{degree_token(r.degree)}", {})
            fires = _fires(r.reports)
            if jax:
                check(fires == jax["lemma_fires"], f"{task}: {fires} fires "
                      f"against BENCH's {jax['lemma_fires']}")
            rec.update(lemma_fires=fires,
                       bench_lemma_fires=jax.get("lemma_fires"),
                       replay_ms=(time.perf_counter() - t) * 1e3,
                       replay_excess=excess)
        print(f"[gradcheck] {json.dumps(rec)}")
    counts = ops.launch_counts()
    # --------------------------------------------------------------------
    check(not any(counts.values()),
          f"the model/train paths launched port kernels: {counts}")
    inproc_s = time.perf_counter() - t_phase
    t = time.perf_counter()
    pooled, tracer = _traced(lambda: check_model(
        "gpt", "dp2xtp2", workers=2, device=device))
    pool_s = time.perf_counter() - t
    check(pooled.workers == 2 and json.dumps(pooled.stable_summary(),
                                             sort_keys=True)
          == json.dumps(inproc.stable_summary(), sort_keys=True),
          "gpt@dp2xtp2 on 2 workers differs from the in-process run")
    check(not any((rep.get("runtime") or {}).get("degraded_reason")
                  for rep in pooled.reports.values()),
          "gpt@dp2xtp2 on 2 workers degraded to in-process")
    spans = _check_worker_spans(tracer, device, "modelcheck pool")
    check(len(spans) == 3, f"modelcheck pool: {len(spans)} worker spans")
    print(f"[phase7] {json.dumps(dict(
        model_tasks=len(model_tasks) + 1, train_tasks=len(train_tasks),
        model_obligations_replayed=len(replayed),
        inproc_s=inproc_s, pool_s=pool_s,
        phase7_s=time.perf_counter() - t_phase, launches=counts,
        card=smi))}")



# The serving-path targets (phase 8): each task's verdict, failing steps and
# lemma fires. tp_decode@2's and batched_decode@2x2's fires are
# BENCH_verify.json's; sp_cache@2's is the JAX package's count on the CPU,
# which the port's equals (tests/test_torch_servecheck_sp.py).
SERVE_TASKS = {
    ("tp_decode", 2, None): ("certificate", [], 180604),
    ("sp_cache", 2, None): ("certificate", [], 494601),
    ("batched_decode", (2, 2), None): ("certificate", [], 5274),
    ("tp_decode", 2, "stale_cache_shard"): ("refinement_error", ["step3"],
                                            None),
    ("sp_cache", 2, "pos_off_by_one"): ("refinement_error", ["step4"], None),
    ("batched_decode", (2, 2), "cache_gather_wrong_axis"):
        ("unexpected_relation", ["step1"], None),
}


def phase8_serve(smi, device="cuda"):
    """Serving-path verification on the card: the three serve strategies
    clean and their three bugs in process (one certificate cache shared
    by the phase, so a bug run proves only the obligations its bug
    changes), each clean obligation replayed, tp_decode@2 again on two
    spawned workers against the in-process run, then the explain smoke's
    three legs. ``device="cpu"`` rehearses it without a card."""
    import tempfile
    from repro_torch.api.replay import max_rel_excess, replay
    from repro_torch.kernels import ops
    from repro_torch.launch import explain_smoke
    from repro_torch.servecheck import check_serve, get_serve_strategy
    bench = json.loads((ROOT / "BENCH_verify.json").read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    # --- the serving-path checks: launches from here to the read ---
    reports = {}
    with tempfile.TemporaryDirectory() as cache:
        for (strategy, degree, bug), (verdict, failing, fires) in \
                SERVE_TASKS.items():
            # in this process (left to itself, check_serve would start a
            # pool for the five obligations of batched_decode or a bug)
            r = check_serve(strategy, degree=degree, bug=bug, workers=1,
                            engine_opts={"explain": True}, cache=cache,
                            device=device)
            reports[(strategy, degree, bug)] = r
            task = r.task_id()
            check(r.ok and r.verdict == verdict
                  and r.failing_steps == failing,
                  f"{task}: {r.verdict}, failing steps {r.failing_steps}")
            got_fires = _fires(r.reports)
            rec = dict(task=task, verdict=r.verdict,
                       failing_steps=r.failing_steps,
                       steps=r.total_steps, obligations=r.unique_obligations,
                       dedup_ratio=r.dedup_ratio, lemma_fires=got_fires,
                       explain_steps=r.explanation["total_steps"],
                       wall_ms=r.wall_s * 1e3,
                       infer_ms=r.timing()["infer_s_sum"] * 1e3,
                       cache_hits=r.cache["hits"],
                       proved_ms={k: r.reports[k]["wall_s"] * 1e3
                                  for k in r.reports
                                  if (r.reports[k].get("runtime") or {})
                                  .get("cache") != "hit"})
            if bug is None:
                check(got_fires == fires, f"{task}: {got_fires} fires, "
                      f"the target is {fires}")
                jax = bench["servecheck"].get(task, {})
                if jax:
                    check(rec["explain_steps"] == jax["explain_steps"],
                          f"{task}: {rec['explain_steps']} explain steps "
                          f"against BENCH's {jax['explain_steps']}")
                t = time.perf_counter()
                obset = get_serve_strategy(strategy).build(degree=degree)
                excess = 0.0
                for key in obset.keys_in_order():
                    got, want = replay(
                        obset.unique[key].to_strategy_spec(name=key), device)
                    excess = max(excess, max_rel_excess(got, want))
                check(excess <= 1.0, f"{task}: replay beyond rtol = atol = "
                      f"2e-4 ({excess})")
                rec.update(bench_lemma_fires=jax.get("lemma_fires"),
                           bench_explain_steps=jax.get("explain_steps"),
                           replay_ms=(time.perf_counter() - t) * 1e3,
                           replay_excess=excess)
            print(f"[servecheck] {json.dumps(rec)}")
    counts = ops.launch_counts()
    # --------------------------------------------------------------------
    check(not any(counts.values()),
          f"the serving-path checks launched port kernels: {counts}")
    inproc_s = time.perf_counter() - t_phase
    t = time.perf_counter()
    pooled, tracer = _traced(lambda: check_serve(
        "tp_decode", degree=2, workers=2, device=device))
    pool_s = time.perf_counter() - t
    inproc = reports[("tp_decode", 2, None)]
    check(pooled.workers == 2 and json.dumps(pooled.stable_summary(),
                                             sort_keys=True)
          == json.dumps(inproc.stable_summary(), sort_keys=True),
          "tp_decode@2 on 2 workers differs from the in-process run")
    check(not any((rep.get("runtime") or {}).get("degraded_reason")
                  for rep in pooled.reports.values()),
          "tp_decode@2 on 2 workers degraded to in-process")
    spans = _check_worker_spans(tracer, device, "servecheck pool")
    check(len(spans) == 4, f"servecheck pool: {len(spans)} worker spans")
    t = time.perf_counter()
    failures = explain_smoke.run(device)
    explain_s = time.perf_counter() - t
    check(not failures, f"explain smoke: {failures}")
    print(f"[phase8] {json.dumps(dict(
        serve_tasks=len(SERVE_TASKS), inproc_s=inproc_s, pool_s=pool_s,
        explain_smoke_s=explain_s, phase8_s=time.perf_counter() - t_phase,
        launches=counts, card=smi))}")


# Phase 9's configurations: gpt at full width and depth (its config's
# docstring: "the 100M end-to-end training driver"), 50 steps of 8 x 1024
# tokens; yi-9b at full width, 8 of its 48 layers (AdamW keeps ~12 bytes a
# parameter: 48 layers are ~106 GB), one sequence of 4096 tokens.
GPT_STEPS, GPT_BATCH, GPT_SEQ = 50, 8, 1024
GRAD_BATCH = 2                 # the gradient check's batch of GPT_SEQ tokens
YI_LAYERS, YI_SEQ, YI_STEPS = 8, 4096, 2
TRAIN_CLI_STEPS = 20           # launch.train's own main, reduced config


@contextlib.contextmanager
def plain_kernels():
    """The models' kernel dispatch sent to the plain versions on the card
    too: the reference path the kernels' gradients are held against."""
    from repro_torch.kernels import flash_attention as fa, ops, rmsnorm as rn
    saved = ops.rmsnorm, ops.flash_attention
    ops.rmsnorm = lambda x, s, eps=1e-6: rn.rmsnorm_plain(x, s, eps)
    ops.flash_attention = lambda q, k, v, *, causal=True, window=0: \
        fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    try:
        yield
    finally:
        ops.rmsnorm, ops.flash_attention = saved


# The backward kernels' device kernels, by the names the profiler gives
# them: K2 bf16's prologue (delta, LSE), main kernel and dQ kernel; K2
# fp32's one kernel (dK/dV and dQ blocks in one grid); K1's pass and its
# column sum (both named rmsnorm_bwd*)
BWD_KERNEL_NAMES = {"flash_attention_bwd_bf16": ("bwd_prologue",
                                                 "flash_bwd_sm90",
                                                 "flash_bwd_dq_sm90"),
                    "flash_attention_bwd_fp32": ("flash_bwd_fp32",),
                    "rmsnorm_bwd": ("rmsnorm_bwd",)}


def _rel_rms(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


# The backward kernels against their plain versions (the closed forms):
# K2 bf16 at every head dim, causal and not, G = H / KV of 1, 2 and 8, at
# whole 128-key tiles and a ragged S; K1 in fp32 and bf16 over widths and
# row counts (the decode's 4, both sides of the backward's one-block plan,
# a ragged count and gpt's training rows).
BWD_HEAD_DIMS = (32, 64, 112, 128, 256)
BWD_GROUPS = (1, 2, 8)
BWD_SEQS = (1024, 1000)
BWD_REL_RMS = 1e-2           # each of dq, dk, dv (bf16; P and dS in bf16)
BWD_REL_RMS_FP32 = 2e-4      # the same in fp32 (3xTF32 products, ~2^-21 each)
LSE_ABS = 1e-3               # the forward's saved log-sum-exp (bf16 route)
LSE_ABS_FP32 = 1e-5          # and the fp32 route's
BWD_NORM_WIDTHS = (128, 768, 1024, 2048, 4096, 5376, 8192)
BWD_NORM_ROWS = (1, 4, 133, 1000, 8192)
# K1's backward limits: dx as the forward's (fp32 1e-5, bf16 3e-2), dscale
# 1e-4 / 1e-2, each |got - want| <= tol (1 + |want|)
BWD_NORM_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (3e-2, 1e-2)}


def backward_kernel_checks(smi):
    """Each backward kernel against its plain version on the card; fails
    on any disagreement. Returns the worst readings."""
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    g = torch.Generator(device="cuda").manual_seed(5)
    t = time.perf_counter()
    worst = {r: dict(dq=0.0, dk=0.0, dv=0.0, lse_abs=0.0)
             for r in ("bf16", "fp32", "bf16_window", "fp32_window")}
    n_attn = 0
    # both routes at every head dim, causal and not, each G, whole and
    # ragged S; then the windowed layers' shapes (WINDOW_ATTN) with their
    # windows in each route they take
    cases = [((2, S, 2 * G, 2, hd), causal, 0, dt)
             for dt in (torch.bfloat16, torch.float32)
             for hd in BWD_HEAD_DIMS for G in BWD_GROUPS
             for causal in (True, False) for S in BWD_SEQS]
    cases += [(shape, True, window, dt)
              for _, shape, window, dts, _ in WINDOW_ATTN for dt in dts]
    for (B, S, H, KV, hd), causal, window, dt in cases:
        q, k, v, dy = (torch.randn(shape, generator=g, device="cuda").to(dt)
                       for shape in ((B, S, H, hd), (B, S, KV, hd),
                                     (B, S, KV, hd), (B, S, H, hd)))
        route = fa.ROUTES[dt]
        lse = fa.new_lse(q)
        out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 lse=lse)
        _, lse_ref = fa.flash_attention_plain_lse(q, k, v, causal=causal,
                                                  window=window)
        got = fa.BACKWARD_KERNELS[route](q, k, v, out, lse, dy,
                                         causal=causal, window=window)
        want = fa.flash_attention_backward(q, k, v, dy, causal, window)
        torch.cuda.synchronize()
        what = f"{route} {(B, S, H, KV, hd)} causal {causal} window {window}"
        w = worst[route + ("_window" if window else "")]
        err = (lse - lse_ref).abs().max().item()
        check(err <= (LSE_ABS if route == "bf16" else LSE_ABS_FP32),
              f"K2 LSE {what}: {err}")
        w["lse_abs"] = max(w["lse_abs"], err)
        limit = BWD_REL_RMS if route == "bf16" else BWD_REL_RMS_FP32
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"K2 backward {name} {what}: {a.shape} {a.dtype}")
            rel = _rel_rms(a, b)
            check(rel <= limit, f"K2 backward {name} {what}: relative RMS "
                  f"{rel} beyond {limit}")
            w[name] = max(w[name], rel)
        n_attn += 1
        del q, k, v, dy, out, got, want
    torch.cuda.empty_cache()
    norm = {}
    for dt, (tol_dx, tol_ds) in BWD_NORM_TOL.items():
        w = norm[str(dt)] = dict(dx=0.0, dscale=0.0)
        for D in BWD_NORM_WIDTHS:
            for rows in BWD_NORM_ROWS:
                x = torch.randn((rows, D), generator=g, device="cuda").to(dt)
                s = (torch.randn(D, generator=g, device="cuda") * 0.1).to(dt)
                dy = torch.randn((rows, D), generator=g,
                                 device="cuda").to(dt)
                dx, ds = rn.rmsnorm_bwd(x, s, dy)
                dx_ref, ds_ref = rn.rmsnorm_backward(x, s, dy)
                w["dx"] = max(w["dx"], max_err(dx, dx_ref, tol_dx))
                w["dscale"] = max(w["dscale"], max_err(ds, ds_ref, tol_ds))
    rec = dict(attention_cases=n_attn, head_dims=list(BWD_HEAD_DIMS),
               groups=list(BWD_GROUPS), seqs=list(BWD_SEQS),
               windows=[(tag, w) for tag, _, w, _, _ in WINDOW_ATTN],
               attention_worst_rel_rms=worst,
               rel_rms_limit={"bf16": BWD_REL_RMS, "fp32": BWD_REL_RMS_FP32},
               rmsnorm_worst_max_abs=norm,
               rmsnorm_widths=list(BWD_NORM_WIDTHS),
               rmsnorm_rows=list(BWD_NORM_ROWS),
               seconds=time.perf_counter() - t, card=smi)
    print(f"[bwd-check] {json.dumps(rec)}")
    return rec


def _synthetic(cfg, batch, seq, step, device):
    from repro_torch.data import SyntheticTextDataset
    return SyntheticTextDataset(vocab=cfg.vocab, seq_len=seq,
                                batch=batch).batch_at(step, device)


def train_gpt(smi):
    """(a) gpt at full width and depth in bf16 through launch.train's step
    function: step ms, tokens/s, peak memory, the loss every 10 steps and
    the launches of every step."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg = registry.load_config("gpt")
    check((cfg.n_layers, cfg.d_model, cfg.vocab, cfg.dtype)
          == (12, 768, 50257, "bfloat16"), f"gpt config {cfg}")
    torch.cuda.reset_peak_memory_stats()
    model, opt = init_state(cfg, 0, "cuda")
    step_fn = make_train_step(cfg, TrainConfig())
    per_step = {"rmsnorm": 2 * cfg.n_layers + 1,
                "flash_attention_bf16": cfg.n_layers,
                "flash_attention_fp32": 0,
                "rmsnorm_bwd": 2 * cfg.n_layers + 1,
                "flash_attention_bwd_bf16": cfg.n_layers,
                "flash_attention_bwd_fp32": 0}
    losses, step_ms, launches = {}, [], {k: 0 for k in per_step}
    for step in range(GPT_STEPS):
        batch = _synthetic(cfg, GPT_BATCH, GPT_SEQ, step, "cuda")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, opt, m = step_fn(model, opt, batch)
        loss = float(m["loss"])            # waits for the step
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        counts = ops.launch_counts()
        check(all(counts[k] == n for k, n in per_step.items()),
              f"gpt step {step}: launches {counts}, a step makes {per_step}")
        for k in per_step:
            launches[k] += counts[k]
        check(math.isfinite(loss), f"gpt step {step}: loss {loss}")
        if step % 10 == 0 or step >= GPT_STEPS - 5:
            losses[step] = loss
    first = losses[0]
    last5 = sum(losses[s] for s in range(GPT_STEPS - 5, GPT_STEPS)) / 5
    check(last5 < first, f"gpt: the last 5 steps' mean loss {last5} is not "
          f"below the first step's {first}")
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    rec = dict(model="gpt", layers=cfg.n_layers, d_model=cfg.d_model,
               batch=[GPT_BATCH, GPT_SEQ], dtype=cfg.dtype,
               steps=GPT_STEPS, first_step_ms=step_ms[0],
               median_step_ms=steady, tokens_per_s=GPT_BATCH * GPT_SEQ
               / steady * 1e3,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss={str(k): v for k, v in losses.items()},
               last5_mean_loss=last5, launches_per_step=per_step,
               launches=launches, card=smi)
    print(f"[train] {json.dumps(rec)}")
    del model, opt
    torch.cuda.empty_cache()
    return rec


def grads_against_plain(smi):
    """(b) the gradients of the kernels' path against autograd through the
    plain versions on the card, same weights, one batch of gpt at full
    width: fp32 (K2's fp32 route) and bf16."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import make_grad_fn, trainable
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(registry.load_config("gpt"), dtype=dtype)
        model = trainable(registry.init_params(cfg, 0, "cuda"))
        batch = _synthetic(cfg, GRAD_BATCH, GPT_SEQ, 0, "cuda")
        grad_fn = make_grad_fn(cfg)
        ops.reset_launch_counts()
        grads, m = grad_fn(model, batch)
        counts = ops.launch_counts()
        route = "flash_attention_bf16" if dtype == "bfloat16" \
            else "flash_attention_fp32"
        # the backward: K1's kernel and K2's of the same dtype
        bwd = route.replace("attention_", "attention_bwd_")
        check(counts["rmsnorm"] == counts["rmsnorm_bwd"] == 2 * cfg.n_layers + 1
              and counts[route] == counts[bwd] == cfg.n_layers
              and counts["flash_attention_bwd_bf16"]
              + counts["flash_attention_bwd_fp32"] == cfg.n_layers,
              f"gpt {dtype} gradient: launches {counts}")
        with plain_kernels():
            ref, mr = grad_fn(model, batch)
        check(ops.launch_counts() == counts,
              "the plain path launched a kernel")
        loss_rel = abs(float(m["loss"]) - float(mr["loss"])) \
            / abs(float(mr["loss"]))
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                              for g in grads.values())).item()
        norm_ref = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                  for g in ref.values())).item()
        leaf = max((_rel_rms(grads[n], ref[n]), n) for n in grads)
        rec = dict(dtype=dtype, loss=float(m["loss"]),
                   plain_loss=float(mr["loss"]), loss_rel=loss_rel,
                   grad_norm=norm, plain_grad_norm=norm_ref,
                   grad_norm_rel=abs(norm - norm_ref) / norm_ref,
                   worst_leaf_rel_rms=leaf[0], worst_leaf=leaf[1],
                   launches=counts, card=smi)
        if dtype == "float32":
            check(loss_rel <= 1e-5 and leaf[0] <= 2e-4,
                  f"fp32 gradients against the plain path: {rec}")
        else:
            check(loss_rel <= 1e-2 and rec["grad_norm_rel"] <= 2e-2,
                  f"bf16 gradients against the plain path: {rec}")
        print(f"[train-grads] {json.dumps(rec)}")
        out[dtype] = rec
        del model, grads, ref
        torch.cuda.empty_cache()
    return out


def train_yi(smi):
    """(c) yi-9b at full width, YI_LAYERS of its 48 layers, one sequence of
    YI_SEQ tokens in bf16, YI_STEPS steps: finite losses, peak memory, the
    launches of each step, and from the profiler the share of a step's
    device time in each backward kernel (by its kernels' names) and in the
    forward kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg = dataclasses.replace(registry.load_config("yi-9b"),
                              n_layers=YI_LAYERS)
    print(f"[train] yi-9b cut to {YI_LAYERS} of 48 layers (AdamW state: "
          f"~12 bytes a parameter)")
    torch.cuda.reset_peak_memory_stats()
    model, opt = init_state(cfg, 0, "cuda")
    step_fn = make_train_step(cfg, TrainConfig())
    losses, step_ms, launches = [], [], {}
    for step in range(YI_STEPS):
        batch = _synthetic(cfg, 1, YI_SEQ, step, "cuda")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if step == YI_STEPS - 1:
            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            with profile(activities=acts) as prof:
                model, opt, m = step_fn(model, opt, batch)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
        else:
            model, opt, m = step_fn(model, opt, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        counts = ops.launch_counts()
        check(counts["rmsnorm"] == counts["rmsnorm_bwd"] == 2 * YI_LAYERS + 1
              and counts["flash_attention_bf16"]
              == counts["flash_attention_bwd_bf16"] == YI_LAYERS,
              f"yi-9b step {step}: launches {counts}")
        launches = {k: launches.get(k, 0) + n for k, n in counts.items()}
    check(all(math.isfinite(x) for x in losses), f"yi-9b losses {losses}")
    kernels = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def named(*keys):
        hit = [e for e in kernels if any(k in e.key for k in keys)]
        ms = sum(e.self_device_time_total for e in hit) / 1e3
        return dict(device_ms=ms, share_of_device_busy=ms / dev_ms,
                    launches=sum(e.count for e in hit))
    shares = {name: named(*keys) for name, keys in BWD_KERNEL_NAMES.items()}
    fwd = {"rmsnorm": named("rmsnorm_rows", "rmsnorm_ring"),
           "flash_fwd": named("flash_fwd")}
    rec = dict(model="yi-9b", layers=YI_LAYERS, d_model=cfg.d_model,
               batch=[1, YI_SEQ], dtype=cfg.dtype, losses=losses,
               step_ms=step_ms, profiled_step_device_busy_ms=dev_ms,
               backward=shares, forward_kernels=fwd, launches=launches,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               n_params=sum(p.numel() for p in model.parameters()),
               card=smi)
    print(f"[train] {json.dumps(rec)}")
    del model, opt, prof
    torch.cuda.empty_cache()
    return rec


def train_cli():
    """(d) launch.train's own main on the card, the reduced config (fp32):
    K2's fp32 route, forward and backward, and K1 on its path, launches
    counted."""
    import io
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli_mod
    ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli_mod.main(["--steps", str(TRAIN_CLI_STEPS)])
    counts = ops.launch_counts()
    lines = out.getvalue().splitlines()
    check([ln.split()[1] for ln in lines]
          == [str(s) for s in range(0, TRAIN_CLI_STEPS, 10)]
          and all(math.isfinite(float(ln.split()[-1])) for ln in lines),
          f"launch.train printed {lines}")
    layers = 2                                 # gpt's reduced() depth
    check(counts["rmsnorm"] == counts["rmsnorm_bwd"]
          == TRAIN_CLI_STEPS * (2 * layers + 1)
          and counts["flash_attention_fp32"]
          == counts["flash_attention_bwd_fp32"] == TRAIN_CLI_STEPS * layers
          and counts["flash_attention_bf16"] == 0
          and counts["flash_attention_bwd_bf16"] == 0,
          f"launch.train: launches {counts}")
    print(f"[train-cli] {json.dumps(dict(lines=lines, launches=counts))}")
    return counts


# Each kernel at the training paths' shapes (tag: path): gpt's full size,
# launch.train's reduced default (fp32: K2's fp32 route, forward and
# backward) and yi-9b's (8 layers, 1 x 4096)
TRAIN_NORM_SHAPES = (("gpt_train", GPT_BATCH * GPT_SEQ, 768, torch.bfloat16),
                     ("train_reduced", 4 * 128, 128, torch.float32),
                     ("yi9b_train", YI_SEQ, D_MODEL, torch.bfloat16),
                     ("gpt_100m", 4 * 256, 768, torch.bfloat16))
TRAIN_ATTN_SHAPES = (("gpt_train", (GPT_BATCH, GPT_SEQ, 12, 12, 64),
                      torch.bfloat16),
                     ("train_reduced", (4, 128, 4, 2, 32), torch.float32),
                     ("yi9b_train", (1, YI_SEQ, 32, 4, 128), torch.bfloat16),
                     # train_gpt_100m's microbatch: 4 of its 8 x 256
                     ("gpt_100m", (4, 256, 12, 12, 64), torch.bfloat16))


# The fp32 backward's device kernels, by the profiler in a process of its
# own: inside this script a profiler session after the first can report
# fewer of a call's kernels than it launched, or none (on an H100: 0.8
# launches a call of a one-launch kernel, then none at all)
_DEVICE_KERNELS = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import flash_attention as fa
B, S, H, KV, hd, calls = map(int, sys.argv[2:])
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v, dy = (torch.randn(B, S, n, hd, generator=g, device="cuda")
               for n in (H, KV, KV, H))
lse = fa.new_lse(q)
out = fa.flash_attention(q, k, v, causal=True, lse=lse)
fn = lambda: fa.flash_attention_bwd_fp32(q, k, v, out, lse, dy, causal=True)
fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
print(json.dumps({e.key: e.count / calls for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU}))
"""


def fp32_backward_kernels(shape, calls=5):
    """{device kernel name: launches a call} of K2's fp32 backward at
    ``shape`` = (B, S, H, KV, hd), causal, profiled in a fresh process
    (the kernels this tree built)."""
    r = subprocess.run([sys.executable, "-c", _DEVICE_KERNELS,
                        str(ROOT / "src"), *map(str, shape), str(calls)],
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"profiling the fp32 backward: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def kernel_split(fn, names, calls=5):
    """Mean device ms a call of ``fn`` in each kernel whose name contains
    one of ``names`` (the profiler's kernel names)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    return {n: sum(e.self_device_time_total for e in evs if n in e.key)
            / 1e3 / calls for n in names}


def train_kernel_records(peaks, smi):
    """Each kernel at the training paths' shapes, forward and backward: the
    kernel, its plain version and one PyTorch call (forward and backward:
    F.rms_norm, scaled_dot_product_attention), timed with CUDA events
    beside the bound; the backward kernels (K1 and K2 in both dtypes) held
    against their plain versions (the closed forms), whose times are kept
    beside them."""
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    bw, bf16_rate, f32_rate = peaks
    rate = {torch.bfloat16: bf16_rate, torch.float32: f32_rate,
            "tf32x3": bf16_rate / 6}
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)

    def bound(nbytes, nops, dt):
        t_bytes, t_ops = nbytes / bw * 1e3, nops / rate[dt] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops \
            else (t_ops, "operations")

    def backward_ms(fn, inputs, dy, it):
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*xs)
        return time_ms(lambda: torch.autograd.grad(out, xs, dy,
                                                   retain_graph=True),
                       it, flush)

    records = []
    for tag, rows, D, dt in TRAIN_NORM_SHAPES:
        x = torch.randn((rows, D), generator=g, device="cuda").to(dt)
        s = (torch.randn(D, generator=g, device="cuda") * 0.1).to(dt)
        dy = torch.randn((rows, D), generator=g, device="cuda").to(dt)
        w = (1.0 + s.float()).to(dt)
        tol, tol_ds = BWD_NORM_TOL[dt]
        n = x.numel() * x.element_size()
        dx, ds = rn.rmsnorm_bwd(x, s, dy)
        dx_ref, ds_ref = rn.rmsnorm_backward(x, s, dy)
        rec = dict(kernel="rmsnorm", tag=tag, shape=[rows, D], dtype=str(dt),
                   plan=rn.plan(rows, D, dt, rn.sm_count(0)).name,
                   backward_plan=rn.backward_plan(rows, D, dt,
                                                  rn.sm_count(0))._asdict(),
                   max_abs_err=max_err(rn.rmsnorm(x, s),
                                       rn.rmsnorm_plain(x, s), tol),
                   backward_max_abs_err=max_err(dx, dx_ref, tol),
                   backward_dscale_max_abs_err=max_err(ds, ds_ref, tol_ds),
                   ms=time_ms(lambda: rn.rmsnorm(x, s), 50, flush),
                   plain_ms=time_ms(lambda: rn.rmsnorm_plain(x, s), 50,
                                    flush),
                   library_ms=time_ms(lambda: F.rms_norm(x, (D,), w, 1e-6),
                                      50, flush),
                   backward_kernel_ms=time_ms(lambda: rn.rmsnorm_bwd(
                       x, s, dy), 50, flush),
                   backward_ms=time_ms(lambda: rn.rmsnorm_backward(
                       x, s, dy, 1e-6), 50, flush),
                   library_backward_ms=backward_ms(
                       lambda x, w: F.rms_norm(x, (D,), w, 1e-6), (x, w),
                       dy, 50))
        rec["bound_ms"], rec["bound_by"] = bound(
            2 * n + s.numel() * s.element_size(), 4 * x.numel(),
            torch.float32)
        # backward: read x, scale, dy; write dx, dscale
        rec["backward_bound_ms"], rec["backward_bound_by"] = bound(
            3 * n + 2 * s.numel() * s.element_size(), 8 * x.numel(),
            torch.float32)
        records.append(rec)
        print(f"[K1 train] {json.dumps(rec)}")
        del x, dy, dx, dx_ref
    for tag, (B, S, H, KV, hd), dt in TRAIN_ATTN_SHAPES:
        q, k, v, dy = (torch.randn(shape, generator=g, device="cuda").to(dt)
                       for shape in ((B, S, H, hd), (B, S, KV, hd),
                                     (B, S, KV, hd), (B, S, H, hd)))
        bf16 = dt == torch.bfloat16
        route = fa.ROUTES[dt]
        lse = fa.new_lse(q)
        got = fa.flash_attention(q, k, v, causal=True, lse=lse)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        rec = dict(kernel=f"flash_attention_{route}", tag=tag,
                   shape=[B, S, H, KV, hd], causal=True, dtype=str(dt))
        if not bf16:
            rec["max_abs_err"] = max_err(got, want, 2e-4)
        else:
            rel = row_rel_err(got, want)
            check(rel <= 1e-2, f"results disagree: worst row relative "
                  f"error {rel} beyond 1e-2")
            rec["max_abs_err"] = (got.float() - want.float()).abs().max() \
                .item()
            rec["row_rel_err"] = rel
        # the backward kernel of the route against the closed form
        bwd = fa.BACKWARD_KERNELS[route]
        grads = bwd(q, k, v, got, lse, dy, causal=True)
        ref = fa.flash_attention_backward(q, k, v, dy, True)
        rels = {n: _rel_rms(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                      grads, ref)}
        check(max(rels.values()) <= (BWD_REL_RMS if bf16
                                     else BWD_REL_RMS_FP32),
              f"K2 backward {tag}: relative RMS {rels}")
        rec["backward_rel_rms"] = rels
        rec["backward_max_abs_err"] = max(
            (a.float() - b.float()).abs().max().item()
            for a, b in zip(grads, ref))
        del grads, ref
        rec["backward_kernel_ms"] = time_ms(
            lambda: bwd(q, k, v, got, lse, dy, causal=True), 20, flush)
        rec["backward_kernels_ms"] = kernel_split(
            lambda: bwd(q, k, v, got, lse, dy, causal=True),
            BWD_KERNEL_NAMES[f"flash_attention_bwd_{route}"]
            + (("bwd_sum_heads",) if bf16 else ()))
        if not bf16:
            # the fp32 backward is one device launch a call
            launched = fp32_backward_kernels((B, S, H, KV, hd))
            rec["backward_device_kernels"] = launched
            check(len(launched) == 1
                  and "flash_bwd_fp32" in next(iter(launched))
                  and next(iter(launched.values())) == 1,
                  f"K2 fp32 backward {tag}: device kernels a call "
                  f"{launched}, not one")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        rec.update(
            ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20,
                       flush),
            plain_ms=time_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=True), 20, flush),
            library_ms=time_ms(lambda: sdpa(qt, kt, vt), 20, flush),
            # the closed form builds (B, H, S, S) fp32 tensors, 2.1 GB
            # each at yi-9b's shape, so fewer calls there
            backward_ms=time_ms(lambda: fa.flash_attention_backward(
                q, k, v, dy, True), 5 if B * H * S * S > 2**28 else 20,
                flush),
            library_backward_ms=backward_ms(sdpa, (qt, kt, vt),
                                            dy.transpose(1, 2), 20))
        pairs = B * H * S * (S + 1) // 2
        es = q.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(
            2 * es * B * S * hd * (H + KV), 4 * hd * pairs, TC_RATE[dt])
        # backward: read q, k, v, dy, the forward's out and LSE, write dq,
        # dk, dv; five products (S recomputed, dP, dV, dQ, dK) over the
        # causal pairs
        reads = es * B * S * hd * (3 * H + 2 * KV) + 4 * B * H * S
        bwd_bytes = reads + es * B * S * hd * (H + 2 * KV)
        rec["backward_bound_ms"], rec["backward_bound_by"] = bound(
            bwd_bytes, 10 * hd * pairs, TC_RATE[dt])
        if not bf16:
            rec["bound_fma_ms"] = bound(2 * es * B * S * hd * (H + KV),
                                        4 * hd * pairs, dt)[0]
            rec["backward_bound_fma_ms"] = bound(bwd_bytes, 10 * hd * pairs,
                                                 dt)[0]
        records.append(rec)
        print(f"[K2 train] {json.dumps(rec)}")
        del q, k, v, dy, got, want
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return {(r["kernel"].split("_")[0], r["tag"]): r for r in records}


def phase9_train(peaks, smi):
    """Training on the card: the backward kernels against their plain
    versions; (a) gpt at full width and depth, 50 steps; (b) its gradients
    against the plain path in fp32 and bf16; (c) yi-9b at full width, 8 of
    48 layers, 2 steps, profiled; (d) launch.train's main on the reduced
    config; then each kernel at these shapes, forward and backward."""
    t = time.perf_counter()
    checks = backward_kernel_checks(smi)
    gpt = train_gpt(smi)
    grads = grads_against_plain(smi)
    yi = train_yi(smi)
    cli = train_cli()
    records = train_kernel_records(peaks, smi)
    print(f"[phase9] {json.dumps(dict(
        phase9_s=time.perf_counter() - t, card=smi))}")
    return dict(checks=checks, gpt=gpt, grads=grads, yi=yi, cli=cli,
                records=records)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase10_mesh(model, prompts, long_prompt, want, smi):
    """(a) yi-9b (phase 2's model, full width and depth, bf16) on a real
    (1, 1) ("data", "model") mesh over a one-rank NCCL group: its
    parameters become DTensors (in place, sharing storage), the prompts
    batch-sharded, both prefills run under use_sharding. The logits must
    equal phase 2's unsharded ones (printed: the max abs difference; fails
    above MESH_REL_RMS relative RMS) with K1 97 and K2 48 launches a
    forward, through the kernels' custom ops; the sharded and unsharded
    prefill ms (their difference is DTensor's host cost) are printed."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh, rules_for_config
    from repro_torch.sharding.specs import (distribute, distribute_params,
                                            placements_for, use_sharding)
    from repro_torch.train import serve
    cfg = model.cfg
    t_phase = time.perf_counter()

    def best_ms(fn, n=3):
        out, ts = None, []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return out, min(ts)

    shapes = {"4x256": prompts, "1x4096": long_prompt}
    plain_ms = {k: best_ms(lambda t=t: serve.prefill_logits(
        model, {"tokens": t}))[1] for k, t in shapes.items()}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        rules = rules_for_config(cfg, mesh)
        distribute_params(model, mesh, rules)
        pl = placements_for(mesh, rules.spec_for(("batch", None)))

        def run(t):
            with use_sharding(mesh, rules):
                return serve.prefill_logits(
                    model, {"tokens": distribute(t, mesh, pl)})

        run(prompts)   # DTensor's sharding caches, outside the count
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        # --- the main path: every launch from here to the read is counted
        got = {k: run(t) for k, t in shapes.items()}
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        # ------------------------------------------------------------------
        mesh_ms = {k: best_ms(lambda t=t: run(t))[1]
                   for k, t in shapes.items()}
        out = dict(card=smi, launches=counts, prefill_ms=mesh_ms,
                   unsharded_prefill_ms=plain_ms,
                   dtensor_host_ms={k: mesh_ms[k] - plain_ms[k]
                                    for k in shapes})
        for (k, g), w in zip(got.items(), want):
            check(type(g).__name__ == "DTensor", f"{k}: logits not a DTensor")
            g = g.full_tensor()
            check(g.shape == w.shape, f"{k}: sharded logits shape")
            diff = (g.float() - w.float())
            out[f"max_abs_diff_{k}"] = diff.abs().max().item()
            out[f"rel_rms_{k}"] = (diff.norm() / w.float().norm()).item()
            check(out[f"rel_rms_{k}"] <= MESH_REL_RMS,
                  f"{k}: sharded logits differ from phase 2's")
    finally:
        dist.destroy_process_group()
    out["phase10a_s"] = time.perf_counter() - t_phase
    print(f"[mesh] {json.dumps(out)}")
    check(counts["rmsnorm"] == 2 * N_NORMS,
          f"rmsnorm launched {counts['rmsnorm']} times on the sharded path, "
          f"not 2 x {N_NORMS}")
    check(counts["flash_attention_bf16"] == 2 * N_LAYERS,
          f"the bf16 attention route launched "
          f"{counts['flash_attention_bf16']} times, not 2 x {N_LAYERS}")
    check(counts["flash_attention_fp32"] == 0,
          "the float32 attention route ran on the sharded bf16 path")
    return out


def phase10_dryrun(smi):
    """(b) the dry run on fake CUDA tensors over the fake 256-rank (and
    512-rank) mesh: DRYRUN_COMBOS, each family and mode at least once
    (the whole sweep is ``python -m repro_torch.launch.dryrun``), none
    that the JAX package's skip_reason skips. Any exception fails, and
    so does a kernel launch."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    outdir = str(ROOT / "experiments" / "dryrun_torch")
    t_phase = time.perf_counter()
    try:
        for arch, shape, multi_pod in DRYRUN_COMBOS:
            ops.reset_launch_counts()
            rec = dryrun.run_combo(arch, shape, multi_pod, outdir,
                                   device="cuda")
            launches = ops.launch_counts()
            check("skipped" not in rec, f"{arch} {shape}: skipped")
            check(all(n == 0 for n in launches.values()),
                  f"{arch} {shape}: the dry run launched {launches}")
            full, roof = rec["full_compile"], rec["roofline"]
            print(f"[dryrun] {json.dumps(dict(
                arch=arch, shape=shape, mesh=rec['mesh'],
                ranks=rec['n_chips'], flops_per_dev=full['flops'],
                bytes_per_dev_unfused=full['bytes_accessed'],
                coll_per_dev=sum(full['collective_bytes'].values()),
                collective_bytes=full['collective_bytes'],
                dominant=roof['dominant'],
                gib_per_dev=roof['mem_per_device_gib'],
                fits_hbm=roof['fits_hbm'], trace_s=full['t_trace_s'],
                launches=sum(launches.values()), card=smi))}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[dryrun] phase 10b: {len(DRYRUN_COMBOS)} combos in "
          f"{time.perf_counter() - t_phase:.1f} s")


def windowed_profiles():
    """``--windowed-profiles``: each windowed model's long prefill under the
    profiler (``windowed_prefill``), one model resident at a time, with
    the package beside this file; builds nothing ahead (the tree's kernels
    build at first use)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    out = {arch: windowed_prefill(arch, smi) for arch in WINDOWED_ARCHS}
    print(json.dumps({arch: dict(
        device_busy_ms=r["device_busy_ms"],
        plain_attention_ms=r["plain_attention_ms"],
        plain_share=r["plain_attention_ms"] / r["device_busy_ms"],
        flash_fwd_ms=r["flash_fwd_ms"], wall_ms=r["wall_ms"],
        flash_attention_launches=r["launches"].get("flash_attention"))
        for arch, r in out.items()}))
    return 0


def fma_bound(rec, prefix=""):
    """An fp32 K2 record's bound at the scalar FMA rate, beside its bound
    at the 3xTF32 rate (nothing for other records)."""
    key = f"{prefix}bound_fma_ms"
    return {key: rec[key]} if key in rec else {}


def main(argv=()):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if list(argv) == ["--windowed-profiles"]:
        return windowed_profiles()
    if argv:
        print(f"chip_smoke: unknown arguments {list(argv)}", file=sys.stderr)
        return 2
    smi = phase0()
    kind = torch.cuda.get_device_name(0)
    peak_key, peaks = peaks_for(kind)
    print(f"peaks: {peak_key} data sheet: {peaks[0] / 1e12} TB/s, "
          f"{peaks[1] / 1e12} TFLOP/s bf16, {peaks[2] / 1e12} TFLOP/s fp32")
    records = phase1(peaks)
    model_check_small()
    counts, row_launches, model, prompts, long_prompt, logits = phase2()
    phase3(model, prompts, long_prompt)
    mesh_run = phase10_mesh(model, prompts, long_prompt, logits, smi)
    del model, logits
    torch.cuda.empty_cache()
    gemma12 = phase3_windowed(smi)
    families = phase6_families()
    train = phase9_train(peaks, smi)
    inproc, inproc_s = phase4_verify()
    drivers = phase11_drivers(inproc, smi)
    phase5_runtime(inproc, inproc_s, smi)
    phase7_checks(smi)
    phase8_serve(smi)
    phase10_dryrun(smi)

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
    attn = dict(shape=[B_PROMPT, S_PROMPT, 32, 4, 128], causal=True,
                window=None)
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
            **fma_bound(rec), card=smi))
    # K2 at the families' shapes, with the launches of the family's path
    for name, shape, causal, dt, arch in (
            ("flash_attention_bf16@hd112", KIMI_ATTN, True, "torch.bfloat16",
             "kimi-k2-1t-a32b"),
            ("flash_attention_fp32@hd112", KIMI_ATTN, True, "torch.float32",
             "kimi-k2-1t-a32b"),
            ("flash_attention_bf16@whisper_encoder", WHISPER_ENC_ATTN, False,
             "torch.bfloat16", "whisper-medium"),
            ("flash_attention_bf16@qwen2_vl", QWEN_ATTN, True,
             "torch.bfloat16", "qwen2-vl-2b"),
            *((f"flash_attention_bf16@{tag}_{B}x{S}", (B, S, H, KV, hd),
               True, "torch.bfloat16", arch)
              for tag, arch, shapes in (
                  ("gemma3_27b", "gemma3-27b", GEMMA27_ATTN),
                  ("command_r", "command-r-35b", CMDR_ATTN))
              for B, S, H, KV, hd in shapes)):
        route = name.split("@")[0]
        rec = next(r for r in records if r["kernel"] == route
                   and r["dtype"] == dt and r["shape"] == list(shape)
                   and r["causal"] == causal and not r.get("window"))
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/"
                   f"{BF16_LIB if 'bf16' in route else 'flash_attention'}.cu",
            replaces=fa_src, launches=families[arch]["launches"][route],
            path=arch,
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "tflops", "bound_share", "host_us",
                                    "library_host_us", "shape")},
            causal=causal, **fma_bound(rec), card=smi))
    # K2 with a window at the windowed layers' shapes, with the K2 launches
    # of the model's path (gemma3-12b: phase 3's two prefills; the others:
    # phase 6's path, global layers included)
    windowed_path = {"gemma3_12b_local": gemma12["launches"],
                     "gemma3_27b_local": families["gemma3-27b"]["launches"],
                     "mixtral": families["mixtral-8x7b"]["launches"],
                     "recurrentgemma_local":
                         families["recurrentgemma-2b"]["launches"]}
    for rec in records:
        if rec.get("tag") not in windowed_path or "ms" not in rec:
            continue
        route = rec["kernel"]
        kernels.append(dict(
            name=f"{route}@{rec['tag']}", route="cuda",
            source=f"src/repro_torch/csrc/"
                   f"{BF16_LIB if 'bf16' in route else 'flash_attention'}.cu",
            replaces=fa_src, launches=windowed_path[rec["tag"]][route],
            path=rec["tag"],
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "tflops", "bound_share", "host_us",
                                    "library_host_us", "shape", "window",
                                    "pairs")},
            causal=True, **fma_bound(rec), card=smi))
    # each kernel at the training path's shapes, with the launches of the
    # phase-9 path that gives it that shape: gpt's 50 steps at full width
    # (bf16), launch.train's reduced default (fp32)
    recs = train["records"]
    launched = {"gpt_train": train["gpt"]["launches"],
                "train_reduced": train["cli"], "yi9b_train": train["yi"]["launches"],
                "gpt_100m": drivers["train_gpt_100m"]["launches"]}
    for name, key, counter in (
            ("rmsnorm@gpt_train", ("rmsnorm", "gpt_train"), "rmsnorm"),
            ("rmsnorm@gpt_100m", ("rmsnorm", "gpt_100m"), "rmsnorm"),
            ("flash_attention_bf16@gpt_100m", ("flash", "gpt_100m"),
             "flash_attention_bf16"),
            ("rmsnorm@train_reduced", ("rmsnorm", "train_reduced"), "rmsnorm"),
            ("flash_attention_bf16@gpt_train", ("flash", "gpt_train"),
             "flash_attention_bf16"),
            ("flash_attention_fp32@train_reduced", ("flash", "train_reduced"),
             "flash_attention_fp32")):
        rec = recs[key]
        src = "rmsnorm.cu" if rec["kernel"] == "rmsnorm" else \
            f"{BF16_LIB if 'bf16' in name else 'flash_attention'}.cu"
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces="src/repro/kernels/rmsnorm.py:21"
            if rec["kernel"] == "rmsnorm" else fa_src,
            launches=launched[key[1]][counter], path="training",
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "backward_ms", "library_backward_ms",
                                    "backward_bound_ms", "shape")},
            **fma_bound(rec), card=smi))
    # the backward kernels on the training paths: ms the kernel's, plain_ms
    # the closed form's, library_ms the PyTorch call's backward
    for name, key, counter, src, replaces in (
            ("rmsnorm_bwd@gpt_train", ("rmsnorm", "gpt_train"), "rmsnorm_bwd",
             "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:21"),
            ("rmsnorm_bwd@train_reduced", ("rmsnorm", "train_reduced"),
             "rmsnorm_bwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:21"),
            ("rmsnorm_bwd@yi9b_train", ("rmsnorm", "yi9b_train"),
             "rmsnorm_bwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:21"),
            ("rmsnorm_bwd@gpt_100m", ("rmsnorm", "gpt_100m"),
             "rmsnorm_bwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:21"),
            ("flash_attention_bwd_bf16@gpt_100m", ("flash", "gpt_100m"),
             "flash_attention_bwd_bf16", f"{BF16_BWD_LIB}.cu", fa_src),
            ("flash_attention_bwd_bf16@gpt_train", ("flash", "gpt_train"),
             "flash_attention_bwd_bf16", f"{BF16_BWD_LIB}.cu", fa_src),
            ("flash_attention_bwd_bf16@yi9b_train", ("flash", "yi9b_train"),
             "flash_attention_bwd_bf16", f"{BF16_BWD_LIB}.cu", fa_src),
            ("flash_attention_bwd_fp32@train_reduced",
             ("flash", "train_reduced"), "flash_attention_bwd_fp32",
             f"{FP32_BWD_LIB}.cu", fa_src)):
        rec = recs[key]
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=replaces, launches=launched[key[1]][counter],
            path="training", max_abs_err=rec["backward_max_abs_err"],
            ms=rec["backward_kernel_ms"], plain_ms=rec["backward_ms"],
            bound_ms=rec["backward_bound_ms"],
            bound_by=rec["backward_bound_by"],
            library_ms=rec["library_backward_ms"], shape=rec["shape"],
            dtype=rec["dtype"], **fma_bound(rec, "backward_"), card=smi))
    # K1 on serve_decode's path (phase 11): gemma3-12b's decode rows
    rec = next(r for r in records if r["kernel"] == "rmsnorm"
               and r["shape"] == [B_PROMPT, GEMMA12_D])
    kernels.append(dict(
        name=f"rmsnorm@serve_decode_{B_PROMPT}x{GEMMA12_D}", route="cuda",
        source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:21",
        launches=drivers["serve_decode"]["launches"]["rmsnorm"],
        plan=rec["plan"], path="serve_decode",
        **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "bound_share",
                                "host_us", "library_host_us", "shape")},
        card=smi))
    # each kernel on phase 10's sharded path (DTensor parameters on a
    # (1, 1) mesh), at the 4 x 256 prefill's shapes
    for name, src, rec, launches in (
            ("rmsnorm@mesh_1x1", "rmsnorm.cu", next(
                r for r in records if r["kernel"] == "rmsnorm"
                and r["shape"] == [B_PROMPT * S_PROMPT, D_MODEL]
                and r["dtype"] == "torch.bfloat16"),
             mesh_run["launches"]["rmsnorm"]),
            ("flash_attention_bf16@mesh_1x1", f"{BF16_LIB}.cu", next(
                r for r in records if r["kernel"] == "flash_attention_bf16"
                and r["dtype"] == "torch.bfloat16"
                and all(r.get(k) == v for k, v in attn.items())),
             mesh_run["launches"]["flash_attention_bf16"])):
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces="src/repro/kernels/rmsnorm.py:21"
            if rec["kernel"] == "rmsnorm" else fa_src,
            launches=launches, path="mesh",
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "shape")},
            **fma_bound(rec), card=smi))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
