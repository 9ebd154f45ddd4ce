"""Phase 13 of ``chip_smoke.py`` (every family's train step on the card),
the parts the CPU can check.

* (a) each phase-13 configuration keeps its published config whole but
  for ``n_layers`` (and ``remat`` where the step's saved activations do
  not fit): every width, and every layer kind of the pattern (gemma3's
  global layer, recurrentgemma's local one);
* (b) its AdamW state, reckoned from ``abstract_params`` on the meta
  device, stays within 48 GB, at the deepest whole periods of the pattern
  that do, and kimi-k2's one published layer reckons more than the card's
  80 GB;
* (c) ``expected_train_launches`` against one train step of each family's
  reduced config through the port's ``make_train_step`` (and with
  ``remat``). On the CPU the kernels' wrappers are not reached (the plain
  versions run and ``ops.launch_counts()`` stays 0, which is checked), so
  the step's calls of ``ops.rmsnorm`` and ``ops.flash_attention`` are
  counted, and their backward by a gradient hook on each output: what the
  CUDA branch turns into one forward and one backward launch; and the
  backwards by shape against ``train_shapes``, which gives phase 13's
  kernel records their shapes and launches;
* (d) the training batch has ``tests/test_arch_smoke.py``'s layout;
* the program's spans whose kernels ``chip_smoke.step_split`` reads by
  their launch calls (``span_split``): every CE piece's forward and
  backward (its recompute and its backward nodes) and AdamW's update in
  one, on a CPU profile; ``span_split``'s arithmetic on a made-up step and
  every span it finds on a CPU step;
* the two faults phase 13 found on the card: the SSD's NaN gradients
  where a chunk's decay overflows, and AdamW's whole-leaf fp32
  temporaries.
"""
import collections
import contextlib
import dataclasses
import functools
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro_torch.kernels import adamw as kernels_adamw
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.models import ssm as tssm
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train import loop
from repro_torch.train.serve import prefill_logits
from test_arch_smoke import _small_batch
from torch_parity import one_thread_module  # noqa: F401 (one thread)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCHS = chip_smoke.TRAIN_ARCHS


@functools.cache
def _spec(arch):
    return chip_smoke.train_spec(arch)


def _kinds(cfg):
    return {cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_config_keeps_published_widths(arch):
    """(a) Only the depth is cut (and remat set where the activations a
    step saves exceed ACT_BUDGET), every layer kind is kept; kimi-k2 trains
    its reduced config with its published 384 experts and top-8."""
    spec = _spec(arch)
    cfg = chip_smoke.spec_config(spec)
    full = registry.load_config(arch)
    if spec["reduced"]:
        assert arch == "kimi-k2-1t-a32b"
        assert cfg == full.reduced(n_experts=384, top_k=8)
        assert (cfg.n_experts, cfg.top_k, cfg.dtype) == (384, 8, "float32")
        return
    changed = {k for k, v in dataclasses.asdict(cfg).items()
               if v != getattr(full, k)}
    assert changed <= {"n_layers", "remat"}
    assert cfg.remat == (spec["activations_gb"] * 1e9
                         > chip_smoke.ACT_BUDGET)
    assert _kinds(cfg) == set(full.pattern)
    assert (cfg.n_layers == full.n_layers
            or cfg.n_layers % len(full.pattern) == 0)
    assert cfg.dtype == "bfloat16"


def test_train_config_remats_only_the_recurrent_families():
    """Where the reckoning puts remat: mamba2 (the SSD chunk loop's fp32
    levels) and recurrentgemma (the RG-LRU scan's), no other."""
    assert {a for a in ARCHS if _spec(a)["remat"]} == {
        "mamba2-1.3b", "recurrentgemma-2b"}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_fits(arch):
    """(b) AdamW's state (12 bytes a parameter, meta device) within
    STATE_BUDGET at the cut depth, and over it one period deeper; kimi-k2's
    single published layer over the card's 80 GB."""
    spec = _spec(arch)
    full = registry.load_config(arch)
    if spec["reduced"]:
        assert spec["layer_state_gb"] * 1e9 > chip_smoke.CARD_BYTES
        one = dataclasses.replace(full, n_layers=1)
        two = dataclasses.replace(full, n_layers=2)
        assert chip_smoke.state_bytes(two) - chip_smoke.state_bytes(one) \
            == spec["layer_state_gb"] * 1e9
        return
    cfg = chip_smoke.spec_config(spec)
    state = chip_smoke.state_bytes(cfg)
    assert state == 12 * sum(p.numel() for p in
                             registry.abstract_params(cfg).parameters())
    assert state <= chip_smoke.STATE_BUDGET
    if cfg.n_layers < full.n_layers:
        deeper = dataclasses.replace(
            full, n_layers=cfg.n_layers + len(full.pattern))
        assert chip_smoke.state_bytes(deeper) > chip_smoke.STATE_BUDGET


@contextlib.contextmanager
def _counted_kernels():
    """Count the calls that reach the kernels' dispatch, by the counters'
    names, and one backward for each output whose gradient is computed;
    the backwards also by shape, as ``chip_smoke.train_shapes`` keys them
    (``_shape_key``)."""
    tally = collections.Counter()
    real_norm, real_fa = ops.rmsnorm, ops.flash_attention

    def counted(y, fwd, bwd, key):
        tally[fwd] += 1
        if y.requires_grad:
            y.register_hook(lambda g: tally.update([bwd, key]))
        return y

    def rmsnorm(x, scale, eps=1e-6):
        D = x.shape[-1]
        return counted(real_norm(x, scale, eps), "rmsnorm", "rmsnorm_bwd",
                       ("rmsnorm", x.numel() // D, D,
                        str(x.dtype).split(".")[1]))

    def flash_attention(q, k, v, *, causal=True, window=0):
        route = tfa.ROUTES[q.dtype]
        B, S, H, hd = q.shape
        return counted(real_fa(q, k, v, causal=causal, window=window),
                       f"flash_attention_{route}",
                       f"flash_attention_bwd_{route}",
                       ("flash_attention", B, S, H, k.shape[2], hd, causal,
                        window, str(q.dtype).split(".")[1]))
    ops.rmsnorm, ops.flash_attention = rmsnorm, flash_attention
    try:
        yield tally
    finally:
        ops.rmsnorm, ops.flash_attention = real_norm, real_fa


def _shape_key(s):
    """A ``train_shapes`` entry as ``_counted_kernels`` tallies it."""
    if s["kernel"] == "rmsnorm":
        return ("rmsnorm", *s["shape"], s["dtype"])
    return ("flash_attention", *s["shape"], s["causal"], s["window"],
            s["dtype"])


TRAIN_CASES = [(a, False) for a in ARCHS] + [
    (a, True) for a in ("mamba2-1.3b", "recurrentgemma-2b", "whisper-medium",
                        "gemma3-12b")]


@pytest.mark.parametrize("arch,remat", TRAIN_CASES)
def test_expected_train_launches_match_a_step(arch, remat):
    """(c) One train step of the reduced config (fp32: K2's fp32 route)
    makes exactly ``expected_train_launches``' calls, forward and
    backward; with remat the blocks' forwards are made again in the
    backward, and ``train_shapes``' backward launches at each shape
    (mamba2's out_norm in fp32 over d_inner, whisper's encoder over its
    frames, local layers with their window). The CPU branch launches
    nothing."""
    cfg = dataclasses.replace(
        chip_smoke.reduced_config(registry.load_config(arch)), remat=remat)
    model, opt = init_state(cfg, 0, "cpu")
    batch = chip_smoke.train_batch(cfg, 2, 32, torch.Generator().manual_seed(0),
                                   "cpu")
    ops.reset_launch_counts()
    with _counted_kernels() as tally:
        _, _, m = make_train_step(cfg, TrainConfig())(model, opt, batch)
    assert torch.isfinite(m["loss"])
    want = chip_smoke.expected_train_launches(cfg)
    assert {k: tally[k] for k in want} == want
    shapes = collections.Counter()
    for s in chip_smoke.train_shapes(cfg, 2, 32):
        shapes[_shape_key(s)] += s["backward"]
    assert {k: n for k, n in tally.items() if isinstance(k, tuple)} \
        == shapes
    assert {k for k in tally if not isinstance(k, tuple)} <= set(want)
    assert not any(ops.launch_counts().values())
    if remat:
        assert want["rmsnorm"] > want["rmsnorm_bwd"]


@pytest.mark.parametrize("arch", ARCHS + ("gpt", "yi-9b"))
def test_train_batch_layout_is_arch_smokes(arch):
    """(d) ``train_batch`` has tests/test_arch_smoke.py's ``_small_batch``
    layout: the same keys and shapes (vlm: S - vision_tokens text tokens
    after the patches, labels over all S; audio: the encoder's frames),
    integer tokens and labels in range."""
    cfg = registry.load_config(arch).reduced()
    want = _small_batch(jregistry.load_config(arch).reduced(), B=2, S=32)
    got = chip_smoke.train_batch(cfg, 2, 32, torch.Generator().manual_seed(0),
                                 "cpu")
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert v.dtype.is_floating_point == (want[k].dtype.kind == "f"), k
    for k in ("tokens", "labels"):
        assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg.vocab


CE_SPANS = ("rt.train.ce", "rt.train.ce.bwd")


def _ranged_events(prof):
    """The outermost CPU events of each of the program's CE and AdamW spans
    (a recompute's ``rt.train.ce`` inside a backward's ``rt.train.ce.bwd``
    is not listed apart): the ops whose kernels ``chip_smoke.step_split``
    gives each."""
    out = {name: [] for name in CE_SPANS + ("rt.adamw.update",)}

    def visit(evs):
        for ev in evs:
            if ev.name in out:
                out[ev.name].append(ev)
            else:
                visit(ev.cpu_children)
    visit([e for e in prof.events() if e.cpu_parent is None
           and e.device_type == DeviceType.CPU])
    return out


def _names(ev):
    out = [ev.name]
    for c in ev.cpu_children:
        out += _names(c)
    return out


@pytest.mark.parametrize("arch", ["gpt", "gemma3-12b"])
def test_step_ranges_hold_the_ce_and_adamw(arch):
    """The program's spans under ``obs.trace.device_ranges`` on a profiled
    CPU step: one ``rt.train.ce`` for each CE piece's forward and one
    ``rt.train.ce.bwd`` for its backward (the checkpoint's recompute and
    the piece's backward nodes nested in it), one ``rt.adamw.update``; no
    CE backward node and no AdamW op outside them; every backward range
    closed; and the step's loss and gradient norm are those of a step with
    the switch off."""
    cfg = registry.load_config(arch).reduced()
    batch = chip_smoke.train_batch(cfg, 2, 32, torch.Generator().manual_seed(0),
                                   "cpu")
    step = make_train_step(cfg, TrainConfig())
    plain = step(*init_state(cfg, 0, "cpu"), batch)[2]
    with obs_trace.device_ranges(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        got = step(*init_state(cfg, 0, "cpu"), batch)[2]
        assert not obs_trace.open_backward_ranges()
    assert not obs_trace.ranges_on()
    for k in ("loss", "grad_norm"):
        assert torch.equal(got[k], plain[k]), k
    ranges = _ranged_events(prof)
    assert len(ranges["rt.adamw.update"]) == 1
    assert len(ranges["rt.train.ce"]) == len(ranges["rt.train.ce.bwd"]) \
        == loop.CE_CHUNKS
    inside = collections.Counter(
        n for name in CE_SPANS for ev in ranges[name] for n in _names(ev))
    everywhere = collections.Counter(
        e.name for e in prof.events() if e.device_type == DeviceType.CPU)
    lse = [n for n in everywhere if n.endswith("LogsumexpBackward0")]
    assert lse and all(inside[n] == everywhere[n] == loop.CE_CHUNKS
                       for n in lse)
    # each piece's forward and its recompute, every one in a range
    assert inside["aten::logsumexp"] == everywhere["aten::logsumexp"] > 0
    adam = collections.Counter(n for n in _names(ranges["rt.adamw.update"][0]))
    assert adam["aten::sqrt"] == everywhere["aten::sqrt"] > 0


def _event(name, start, end, device=DeviceType.CPU, id=0):
    return types.SimpleNamespace(
        name=name, id=id, device_type=device,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_span_split_reads_kernels_by_launch_call():
    """``chip_smoke.span_split`` on a made-up step (us): a kernel feeds the
    readings of the spans around its launch call, not where it runs; the
    MoE block's backward less its products' is dispatch; the spans'
    device annotations are no kernels; a kernel with no launch call is
    counted apart; K1's kernel in AdamW is foreign; the idle inside the
    step less the profiler's own events is the program's."""
    cuda = DeviceType.CUDA
    events = [
        _event("rt.train.step", 0, 100), _event("rt.moe.route", 10, 20),
        _event("rt.moe.bwd", 40, 70), _event("rt.moe.experts.bwd", 50, 60),
        _event("rt.adamw.update", 80, 95),
        _event("Activity Buffer Request", 30, 35),
        _event("cudaLaunchKernel", 12, 13, id=1),
        _event("cudaLaunchKernel", 45, 46, id=2),
        _event("cudaLaunchKernel", 55, 56, id=3),
        _event("cudaLaunchKernel", 85, 86, id=4),
        _event("cudaLaunchKernel", 82, 83, id=5),
        _event("indexFuncLargeIndex", 14, 18, cuda, 1),
        _event("rt.moe.route", 13, 19, cuda, 1),
        # launched in the block's backward, run after its close
        _event("indexing_backward_kernel", 46, 52, cuda, 2),
        _event("nvjet_tst", 55, 65, cuda, 3),
        _event("elementwise_kernel", 86, 90, cuda, 4),
        _event("rmsnorm_rows", 90, 91, cuda, 5),
        _event("orphan", 96, 97, cuda, 6)]
    got = chip_smoke.span_split(events)
    ms = {k: round(v, 9) for k, v in got["span_ms"].items()}
    assert ms == dict(chunked_ce=0, adamw=0.005, accumulate=0,
                      moe_dispatch=0.010, moe_experts=0.010,
                      train_step=0.025, prefill=0)
    assert got["ranged_ms"] == {"chunked_ce": {},
                                "adamw": {"rest": 0.004, "k1_forward": 0.001}}
    assert got["unlinked_kernels"] == 1
    assert got["foreign_kernels"] == {"rmsnorm_rows": 1}
    assert got["spans"] == ["rt.adamw.update", "rt.moe.bwd",
                            "rt.moe.experts.bwd", "rt.moe.route",
                            "rt.train.step"]
    # idle in [0, 100]: 74 us of no kernel, 5 of them the profiler's
    assert round(got["program_idle_ms"], 9) == 0.069
    assert got["top_span_ms"] == 0.1


def test_span_split_finds_every_span_of_a_cpu_step():
    """On a CPU profile of a tiny mixtral step (2 microbatches) and one
    prefill under ``obs.trace.device_ranges``, ``span_split`` finds every
    span ``STEP_SPANS`` names, with no kernel to give them; the MoE
    counters' change (``moe_counts``) is the step's and the prefill's."""
    cfg = registry.load_config("mixtral-8x7b").reduced()
    batch = chip_smoke.train_batch(cfg, 2, 32, torch.Generator().manual_seed(0),
                                   "cpu")
    model, opt = init_state(cfg, 0, "cpu")
    step = make_train_step(cfg, TrainConfig(microbatches=2))
    before = chip_smoke.moe_counts()
    with obs_trace.device_ranges(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        model, opt, _ = step(model, opt, batch)
        prefill_logits(model, {"tokens": batch["tokens"][:1]})
    got = chip_smoke.span_split(prof.events())
    names = {n for spans in chip_smoke.STEP_SPANS.values() for n in spans}
    assert set(got["spans"]) == names | {chip_smoke.MOE_BWD}
    assert not any(got["span_ms"].values()) and not got["foreign_kernels"]
    assert got["unlinked_kernels"] == 0
    assert 0 < got["program_idle_ms"] <= got["top_span_ms"]
    moe = {k: v - before[k] for k, v in chip_smoke.moe_counts().items()}
    # 2 microbatches and a prefill of one sequence, each layer's block
    assert moe["moe.rows_routed"] == (2 * 32 + 32) * cfg.top_k * cfg.n_layers
    assert 0 < moe["moe.rows_kept"] <= moe["moe.slots"]


# --- faults phase 13 found on the card -------------------------------------

def _ssd_inputs(dt_value, chunk=8, seed=0):
    rng = np.random.default_rng(seed)
    b, s, h, p, n = 1, 2 * chunk, 2, 4, 3
    return dict(x=rng.normal(size=(b, s, h, p)),
                dt=np.full((b, s, h), dt_value) * rng.uniform(0.5, 1.0,
                                                              (b, s, h)),
                A=-rng.uniform(0.5, 1.5, h), Bm=rng.normal(size=(b, s, n)),
                Cm=rng.normal(size=(b, s, n)))


def _jax_ssd_grads(inp, chunk, dtype):
    def f(x, dt, A, Bm, Cm):
        return jnp.sum(jssm.ssd_chunked(x, dt, A, Bm, Cm, chunk)[0] ** 2)
    args = [jnp.asarray(inp[k], dtype) for k in ("x", "dt", "A", "Bm", "Cm")]
    return [np.asarray(g, np.float64)
            for g in jax.grad(f, argnums=(0, 1, 2, 3, 4))(*args)]


def _torch_ssd_grads(inp, chunk):
    args = [torch.tensor(inp[k], dtype=torch.float32, requires_grad=True)
            for k in ("x", "dt", "A", "Bm", "Cm")]
    (tssm.ssd_chunked(*args, chunk) ** 2).sum().backward()
    return [a.grad.double().numpy() for a in args]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# each gradient's relative limit: float32 rounding, but A's (the decay
# rate's, a sum over the chunk's cumulative decays, which reach ~200 here)
# keeps ~5e-5 of float32's rounding of those sums
SSD_REL = {"x": 1e-5, "dt": 1e-5, "A": 1e-3, "Bm": 1e-5, "Cm": 1e-5}


@pytest.mark.parametrize("dt_value", [0.5, 12.0])
def test_ssd_gradients_stay_finite_where_the_decay_overflows(dt_value):
    """mamba2 at its published width trained to NaN on the card after one
    step: within a chunk the segment sums above the diagonal grow with the
    decay, exp overflows to inf there, and the JAX package's mask after the
    exp gives those entries a gradient of 0 * inf. At a decay that
    overflows float32 (dt ~12 over a chunk of 16: sums past 88) JAX's
    float32 gradients are NaN (the reference's own fault); the port's,
    masked before the exp, are finite and equal JAX's float64 ones (where
    exp does not overflow). At a mild decay the port's equal JAX's float32
    ones too, as before."""
    chunk = 16
    inp = _ssd_inputs(dt_value, chunk)
    got = _torch_ssd_grads(inp, chunk)
    with jax.enable_x64(True):
        want = _jax_ssd_grads(inp, chunk, jnp.float64)
    jax32 = _jax_ssd_grads(inp, chunk, jnp.float32)
    assert any(np.isnan(g).any() for g in jax32) == (dt_value > 10)
    for name, g, w, w32 in zip(SSD_REL, got, want, jax32):
        assert np.isfinite(g).all(), name
        assert _rel(g, w) <= SSD_REL[name], name
        if dt_value < 10:
            assert _rel(g, w32) <= SSD_REL[name], name


def _adamw_trees(shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {k: torch.randn(s, generator=g).to(torch.bfloat16)
              for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=g).to(torch.bfloat16)
             for k, s in shapes.items()}
    return params, grads


ADAMW_SHAPES = {"rows": (40, 7), "experts": (3, 50, 2), "small": (10,),
                "scalar": ()}


@pytest.mark.parametrize("clip_norm", [0.0, 1.0])
def test_adamw_updates_a_large_leaf_in_runs_of_rows(monkeypatch, clip_norm):
    """gemma3-27b (a 1.41 B-element embedding) and command-r (2.10 B) ran
    out of the card's memory in AdamW's update: each leaf's update made ~5
    fp32 temporaries of its whole size. A leaf past UPDATE_CHUNK elements
    is now updated a run of rows at a time: the parameters and both
    moments after three steps equal the whole-leaf update's bit for bit
    (without clipping; with it the norm sums each run apart, within
    1e-6)."""
    cfg = adamw.AdamWConfig(clip_norm=clip_norm, warmup_steps=1)

    def run(chunk):
        monkeypatch.setattr(kernels_adamw, "UPDATE_CHUNK", chunk)
        params, _ = _adamw_trees(ADAMW_SHAPES)
        state = adamw.init(params)
        norms = []
        for i in range(3):
            norms.append(adamw.update(_adamw_trees(ADAMW_SHAPES, i + 1)[1],
                                      state, params, cfg)[2])
        return params, state, norms
    whole, runs = run(1 << 30), run(64)
    for a, b in ((whole[0], runs[0]), (whole[1]["mu"], runs[1]["mu"]),
                 (whole[1]["nu"], runs[1]["nu"])):
        for k in ADAMW_SHAPES:
            if clip_norm:
                torch.testing.assert_close(a[k].float(), b[k].float(),
                                           rtol=1e-6, atol=1e-6)
            else:
                assert torch.equal(a[k], b[k]), k
    for a, b in zip(whole[2], runs[2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_adamw_temporaries_stay_within_a_run(monkeypatch):
    """Every fp32 tensor the update makes (the norm's squares, the moments'
    and the step's terms) holds at most UPDATE_CHUNK elements, whatever the
    leaf's size."""
    from torch.utils._python_dispatch import TorchDispatchMode
    monkeypatch.setattr(kernels_adamw, "UPDATE_CHUNK", 512)

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func._schema.is_mutable:
                for t in torch.utils._pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor) \
                            and t.dtype == torch.float32:
                        Largest.most = max(Largest.most, t.numel())
            return out
    params, grads = _adamw_trees({"embed": (1000, 8), "b": (8,)})
    state = adamw.init(params)
    with Largest():
        adamw.update(grads, state, params, adamw.AdamWConfig())
    assert 0 < Largest.most <= 512


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
def test_expected_train_launches_count_adamw_a_leaf(clip):
    """A train step's expected launches on the card hold AdamW's two
    kernels, a launch a leaf each (the norm's only with clipping), beside
    K1's and K2's, which the leaves leave as they were."""
    cfg = chip_smoke.reduced_config(registry.load_config("mixtral-8x7b"))
    model, _ = init_state(cfg, 0, "cpu")
    leaves = len(list(model.parameters()))
    want = chip_smoke.expected_train_launches(cfg, leaves=leaves, clip=clip)
    assert want["adamw_update"] == leaves > 0
    assert want["adamw_sumsq"] == (leaves if clip else 0)
    rest = {k: n for k, n in want.items() if not k.startswith("adamw_")}
    assert rest == chip_smoke.expected_train_launches(cfg)


def test_adamw_entries_give_each_kernel_its_own_parts():
    """The kernels line's AdamW entries: each kernel's own ms, bound,
    plain part, host time and error (the norm's against fp64, the
    update's the largest of p, m and v against the plain arithmetic), and
    the launches a train step made."""
    rec = dict(leaves=3, launches={"adamw_sumsq": 3, "adamw_update": 3},
               sumsq_ms=1.0, update_ms=6.0, sumsq_plain_ms=9.0,
               update_plain_ms=50.0, sumsq_bound_ms=0.9,
               update_bound_ms=5.0, sumsq_bound_share=0.9,
               update_bound_share=5 / 6, sumsq_host_ms=0.1,
               update_host_ms=0.2, sumsq_max_abs_err=1e-9,
               update_max_abs_err=dict(p=0.0, m=0.0, v=0.0))
    got = {e["name"]: e for e in chip_smoke.adamw_entries({"cell": rec}, {})}
    assert set(got) == {"adamw_sumsq@cell", "adamw_update@cell"}
    for kernel in ("sumsq", "update"):
        e = got[f"adamw_{kernel}@cell"]
        assert (e["ms"], e["plain_ms"], e["bound_ms"], e["host_ms"]) == (
            rec[f"{kernel}_ms"], rec[f"{kernel}_plain_ms"],
            rec[f"{kernel}_bound_ms"], rec[f"{kernel}_host_ms"])
        assert e["launches"] == 3
    assert got["adamw_sumsq@cell"]["max_abs_err"] == 1e-9
    assert got["adamw_update@cell"]["max_abs_err"] == 0.0


@pytest.mark.parametrize("rc,cells", [(0, 2), (0, 1), (1, 2)],
                         ids=["whole", "a_cell_missing", "failed"])
def test_adamw_worker_gives_its_records_by_cell(monkeypatch, rc, cells):
    """``run_adamw_worker`` runs ``--adamw-kernels CARD`` in a process of
    its own and gives its ``[adamw]`` records by cell; a process that exits
    non-zero or leaves a cell out fails the check."""
    import json
    import subprocess
    tags = [c[0] for c in chip_smoke.ADAMW_CELLS]
    out = "built\n" + "".join(f"[adamw] {json.dumps(dict(cell=t, ms=1.5))}\n"
                              for t in tags[:cells])

    def fake_run(cmd, **kwargs):
        assert cmd[-2:] == ["--adamw-kernels", "card"]
        return subprocess.CompletedProcess(cmd, rc, out)
    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    if rc or cells < len(tags):
        with pytest.raises(RuntimeError, match="adamw_kernels' process"):
            chip_smoke.run_adamw_worker("card")
    else:
        got = chip_smoke.run_adamw_worker("card")
        assert list(got) == tags
        assert all(got[t] == dict(cell=t, ms=1.5) for t in tags)
