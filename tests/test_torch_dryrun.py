"""The port's dry run (repro_torch.launch.dryrun) on the CPU: fake tensors
over fake process groups (each test tears its group down).

A reduced gpt prefill on a fake (2, 2) mesh must do a quarter of the
unsharded model's product FLOPs on rank 0 and all-reduce exactly the
analytic tensor-parallel bytes; every family's reduced train step,
prefill and decode step must trace with no kernel launched; the CLI must
write the JAX package's record schema; and K1's and K2's fake
implementations must give the kernels' shapes and dtypes.
"""
import json
import os
import re
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import registry as treg
from repro_torch.models.config import InputShape
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = treg.ARCH_IDS + ["gpt"]
PRODUCTS = ("aten.mm", "aten.addmm", "aten.bmm")


@pytest.fixture
def mesh22():
    mesh = tmesh.make_fake_mesh((2, 2), ("data", "model"), device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def _shape(cfg, mode, B=4, S=64):
    return InputShape(mode, S + (cfg.vision_tokens if cfg.family == "vlm"
                                 else 0), B, mode)


def test_sharded_prefill_does_a_quarter_of_the_products(mesh22):
    """dp2 x tp2: rank 0's product and attention FLOPs x 4 are the
    unsharded model's; the tensor-parallel all-reduces (each layer's
    attention and MLP outputs, row-parallel partial sums) move
    2 x layers x (B/2) x S x D x 4 bytes."""
    cfg = treg.load_config("gpt").reduced()
    shape = _shape(cfg, "prefill")
    rules = tmesh.rules_for_config(cfg, mesh22)
    assert rules.rules["heads"] == rules.rules["ff"] == "model"
    with FakeTensorMode():
        sharded = dryrun.count(*dryrun.build_prefill(cfg, shape, mesh22,
                                                     rules, "cpu"))
        model = treg.build_model(cfg, "cpu")
        tokens = torch.empty((shape.global_batch, shape.seq_len),
                             dtype=torch.int32)
        plain = dryrun.count(
            lambda: treg.forward(model, {"tokens": tokens})[0],
            (list(model.parameters()), tokens))
    local, full = sharded[1].by_op, plain[1].by_op
    assert sum(full.get(k, 0) for k in PRODUCTS) > 0
    assert 4 * sum(local.get(k, 0) for k in PRODUCTS) == \
        sum(full.get(k, 0) for k in PRODUCTS)
    attn = "repro_torch.flash_attention"
    assert full[attn] > 0 and 4 * local[attn] == full[attn]
    B, S, D = shape.global_batch, shape.seq_len, cfg.d_model
    assert sharded[0]["collective_bytes"]["all-reduce"] == \
        2 * cfg.n_layers * (B // 2) * S * D * 4
    assert "all-reduce" not in plain[0]["collective_bytes"]


@pytest.mark.parametrize("mode", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_traces_on_a_fake_mesh(mesh22, arch, mode):
    """The reduced config's step on DTensor fake shards: some work, no
    kernel launched; the train step updates parameters and moments in
    place (all aliased), decode writes the KV caches in place."""
    cfg = treg.load_config(arch).reduced()
    shape = _shape(cfg, mode)
    ops.reset_launch_counts()
    rec = dryrun.trace_and_analyze(cfg, shape, mesh22,
                                   tmesh.rules_for_config(cfg, mesh22), "cpu")
    assert all(n == 0 for n in ops.launch_counts().values())
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["mem_args"] > 0 and rec["mem_temp"] > 0
    if mode == "train":
        # params, moments and the step count come back as they went in
        assert rec["mem_args"] - rec["mem_alias"] > 0
        assert rec["mem_out"] - rec["mem_alias"] < 64
    elif mode == "prefill":
        assert rec["mem_alias"] == 0
    elif cfg.family in ("dense", "vlm", "moe"):
        assert rec["mem_alias"] > 0


@pytest.mark.parametrize("arch,shape,var", [
    ("yi-9b", "decode_32k", "REPRO_DECODE_SEQ_SHARD=1"),
    ("mixtral-8x7b", "decode_32k", "REPRO_MOE_FACTORED=1"),
    ("gpt", "train_4k", "REPRO_SP_RESIDUAL=0")])
def test_plan_variables_trace(tmp_path, monkeypatch, arch, shape, var):
    """The JAX dry run's plan variables, with its names: the reduced
    config's record on the production mesh (factored (16, 4, 4) for the
    MoE), traced with no kernel launched."""
    name, value = var.split("=")
    monkeypatch.setenv(name, value)
    ops.reset_launch_counts()
    try:
        rec = dryrun.run_combo(arch, shape, False, str(tmp_path),
                               device="cpu",
                               cfg=treg.load_config(arch).reduced())
    finally:
        torch.distributed.destroy_process_group()
    assert rec["n_chips"] == 256 and rec["full_compile"]["flops"] > 0
    assert all(n == 0 for n in ops.launch_counts().values())


def test_remat_recompute_finds_the_mesh_on_another_thread(mesh22):
    """On CUDA the backward runs on autograd's device thread, where the
    forward's thread-local sharding context is unset: remat's recompute
    must take the mesh with it. Here the backward runs on a new thread,
    with the residual's seq sharded (REPRO_SP_RESIDUAL's rules), whose
    product needs the recompute's constrains."""
    import threading
    from dataclasses import replace
    from repro_torch.sharding.specs import use_sharding
    cfg = replace(treg.load_config("gpt").reduced(), remat=True)
    rules = tmesh.rules_for_config(cfg, mesh22).with_(seq="model")
    out = {}
    with FakeTensorMode() as fake:
        model = dryrun._model(cfg, mesh22, rules, "cpu", trainable=True)
        batch = dryrun._batch(cfg, _shape(cfg, "train"), mesh22, rules,
                              "cpu")

        def backward(loss):
            # autograd's engine hands its device thread the caller's
            # C++ thread-local state (DTensor's implicit replication
            # among it), not Python's threading.local
            from torch.distributed.tensor.experimental import \
                implicit_replication
            try:
                with fake, implicit_replication():
                    out["grads"] = torch.autograd.grad(
                        loss, list(model.parameters()), allow_unused=True)
            except Exception as e:  # noqa: BLE001 — reported below
                out["error"] = e

        with use_sharding(mesh22, rules):
            hidden, _ = treg.forward(model, batch, return_hidden=True)
            # this thread waits in its context, as a CUDA step's does
            t = threading.Thread(target=backward,
                                 args=(hidden.float().sum(),))
            t.start()
            t.join()
    assert "error" not in out, repr(out.get("error"))
    names = [n for n, _ in model.named_parameters()]
    assert all(g is not None for n, g in zip(names, out["grads"])
               if n.startswith("blocks."))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_on_dtensors_keys_the_lse_flag(mesh22, dtype):
    """DTensor's sharding cache keys a custom op's non-tensor arguments
    only from its first int on: the forward op's ``window`` leads them, so
    a call that keeps the LSE after one that does not (the same shapes and
    placements, as a recompute after a no-grad forward) gets (B, H, S) and
    not the cached (B, H, 0); and each window its own entry."""
    from torch.distributed.tensor import Shard
    from repro_torch.sharding.specs import distribute
    B, S, H, KV, hd = 4, 32, 4, 2, 32
    with FakeTensorMode():
        q, k = (distribute(torch.empty(B, S, n, hd, dtype=dtype), mesh22,
                           (Shard(0), Shard(2))) for n in (H, KV))
        for keep in (False, True, False):
            for window in (0, 8):
                out, lse = ops.flash_attention_op(q, k, k, window, True,
                                                  keep)
                assert tuple(lse.shape) == (B, H, S if keep else 0)
                assert tuple(out.shape) == (B, S, H, hd)


def test_constrain_gives_a_contiguous_shard(mesh22):
    """A gather of an uneven shard can leave a slice of a padded buffer as
    the local tensor; constrain hands on a contiguous one, which a later
    product's view can take."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.sharding.specs import constrain, use_sharding
    rules = tmesh.rules_for_config(treg.load_config("gpt").reduced(), mesh22)
    with FakeTensorMode():
        padded = torch.empty(2, 10, 8)[:, :9]
        x = DTensor.from_local(padded, mesh22, (Shard(0), Replicate()),
                               run_check=False, shape=(4, 9, 8),
                               stride=(72, 8, 1))
        assert not x.to_local().is_contiguous()
        x.requires_grad_(True)
        with use_sharding(mesh22, rules):
            y = constrain(x, ("batch", None, "embed"))
        assert y.placements == x.placements and y.shape == x.shape
        assert y.to_local().is_contiguous()
        assert tuple(y.to_local().reshape(-1, 8).shape) == (18, 8)
        # and the gradient that comes back through it
        grads = []
        x.register_hook(lambda g: grads.append(g))
        dy = DTensor.from_local(torch.empty(2, 10, 8)[:, :9], mesh22,
                                y.placements, run_check=False,
                                shape=y.shape, stride=y.stride())
        y.backward(dy)
        assert grads[0].to_local().is_contiguous()


def _jax_keys(fn_name: str) -> list:
    """The keys of the dict literal a function of the JAX dry run returns
    (read from its source: importing it would force 512 host devices)."""
    src = open(os.path.join(ROOT, "src", "repro", "launch",
                            "dryrun.py")).read()
    body = src.split(f"def {fn_name}(")[1].split("\ndef ")[0]
    ret = body[body.rindex("return {"):]
    return re.findall(r'^\s+"(\w+)":', ret, re.M)


def test_cli_writes_the_jax_record_schema(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gpt",
         "--shape", "prefill_32k", "--mesh", "pod", "--device", "cpu",
         "--outdir", str(tmp_path)], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "unfused upper bound" in r.stdout
    rec = json.load(open(tmp_path / "gpt_prefill_32k_pod16x16.json"))
    assert list(rec) == ["arch", "shape", "mesh", "n_chips", "full_compile",
                         "extrapolated", "roofline"]
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_chips"]) == \
        ("gpt", "prefill_32k", "pod16x16", 256)
    jax_full = _jax_keys("compile_and_analyze")
    assert [k for k in jax_full if k not in ("t_lower_s", "t_compile_s")] \
        + ["t_trace_s"] == list(rec["full_compile"])
    assert set(rec["extrapolated"]) == {"flops", "bytes_accessed",
                                        "collective_bytes"}
    assert list(rec["roofline"]) == _jax_keys("roofline")
    assert set(rec["full_compile"]["collective_bytes"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert rec["full_compile"]["flops"] > 0


def test_cli_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "gpt", "--shape", "prefill_32k"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 128), (2, 16, 256), (3, 5, 8, 128)])
def test_rmsnorm_fake_is_the_kernels_shape_and_dtype(shape, dtype):
    x = torch.randn(shape).to(dtype)
    s = torch.randn(shape[-1:]).to(dtype)
    want = rn.rmsnorm_plain(x, s)
    with FakeTensorMode() as mode:
        got = ops.rmsnorm(mode.from_tensor(x), mode.from_tensor(s))
    assert (got.shape, got.dtype) == (want.shape, want.dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 64, 4, 4, 128),
                                          (2, 48, 8, 2, 112)])
def test_flash_fake_is_the_kernels_shape_and_dtype(B, S, H, KV, hd, dtype,
                                                   causal):
    q = torch.randn(B, S, H, hd).to(dtype)
    k = torch.randn(B, S, KV, hd).to(dtype)
    want = fa.flash_attention_plain(q, k, k, causal=causal)
    with FakeTensorMode() as mode:
        qf, kf = mode.from_tensor(q), mode.from_tensor(k)
        got = ops.flash_attention(qf, kf, kf, causal=causal)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    # the FLOP formula: the kernel's own arithmetic
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode() as mode, FlopCounterMode(display=False) as fc:
        ops.flash_attention(mode.from_tensor(q), mode.from_tensor(k),
                            mode.from_tensor(k), causal=causal)
    pairs = S * (S + 1) // 2 if causal else S * S
    assert fc.get_total_flops() == 4 * B * H * hd * pairs


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_op_fake_and_flop_formula(dtype, causal):
    """The forward op returns the LSE (B, H, S) only for a call that keeps
    it for the backward kernel ((B, H, 0) otherwise); the backward
    op's fake implementation gives the gradients' shapes and dtypes, and
    its FLOP formula the kernel's five products, 10 hd a visited pair."""
    from torch.utils.flop_counter import FlopCounterMode
    B, S, H, KV, hd = 2, 48, 8, 2, 64
    q = torch.randn(B, S, H, hd).to(dtype)
    k = torch.randn(B, S, KV, hd).to(dtype)
    with FakeTensorMode() as mode:
        qf, kf = mode.from_tensor(q), mode.from_tensor(k)
        for keep in (True, False):
            out, lse = ops.flash_attention_op(qf, kf, kf, 0, causal, keep)
            n = S if keep else 0
            assert (tuple(lse.shape), lse.dtype) == ((B, H, n),
                                                     torch.float32)
        with FlopCounterMode(display=False) as fc:
            grads = ops.flash_attention_backward_op(qf, kf, kf, out, lse, qf,
                                                    causal)
    assert [(tuple(g.shape), g.dtype) for g in grads] == \
        [((B, S, H, hd), dtype), ((B, S, KV, hd), dtype),
         ((B, S, KV, hd), dtype)]
    pairs = S * (S + 1) // 2 if causal else S * S
    assert fc.get_total_flops() == 10 * B * H * hd * pairs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_op_fake_and_flop_formula(dtype):
    from torch.utils.flop_counter import FlopCounterMode
    x = torch.randn(3, 5, 256).to(dtype)
    s = torch.randn(256).to(dtype)
    with FakeTensorMode() as mode, FlopCounterMode(display=False) as fc:
        xf = mode.from_tensor(x)
        dx, ds = ops.rmsnorm_backward_op(xf, mode.from_tensor(s), xf, 1e-6)
    assert (tuple(dx.shape), dx.dtype, tuple(ds.shape), ds.dtype) == \
        ((3, 5, 256), dtype, (256,), dtype)
    assert fc.get_total_flops() == 8 * x.numel()


def test_train_trace_counts_the_backward_ops():
    """A traced train step (reduced gpt, one rank, fake tensors) counts the
    backward ops by their own FLOP formulas: K2's backward 10 / 4 of its
    forward's, K1's 2 x its forward's."""
    cfg = treg.load_config("gpt").reduced()
    with FakeTensorMode():
        model = treg.build_model(cfg, "cpu")
        for p in model.parameters():
            p.requires_grad_(True)
        tokens = torch.zeros((2, 64), dtype=torch.int32)

        def step():
            logits = treg.forward(model, {"tokens": tokens})[0]
            return torch.autograd.grad(logits.float().sum(),
                                       list(model.parameters()))
        ops.reset_launch_counts()
        _, trace = dryrun.count(step, (list(model.parameters()), tokens))
    assert all(n == 0 for n in ops.launch_counts().values())
    by = trace.by_op
    assert by["repro_torch.flash_attention_backward"] * 4 == \
        by["repro_torch.flash_attention"] * 10
    assert by["repro_torch.rmsnorm_backward"] == 2 * by["repro_torch.rmsnorm"]
