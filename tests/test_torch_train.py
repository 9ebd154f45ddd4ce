"""The port's training path against the JAX package's, on the CPU.

* gradient formulas: ``rmsnorm_backward`` and ``flash_attention_backward``
  (the closed forms: the backward kernels' plain versions) against
  ``jax.vjp`` of ``repro.kernels.ref``'s oracles, fp32 within 1e-5: causal
  and not, GQA, hd 32/64/128; and the same through the kernels' custom ops
  (the path DTensors and fake tensors take: the forward op's LSE, the
  backward ops), on CPU tensors;
* the train step: the same weights (``convert.from_jax``) and the same
  ``SyntheticTextDataset``-style batch through the port's
  ``make_grad_fn`` / ``make_train_step`` and JAX's ``jax.value_and_grad``
  / ``make_train_step`` in fp32, at every reduced config that
  tests/test_arch_smoke.py trains, with ``microbatches=2`` and with
  ``z_loss``: the loss, the gradient's global norm and each gradient leaf
  within 1e-4 relative;
* ``adamw.update`` against JAX's on the same given gradients (Adam maps a
  near-zero gradient to +-lr whatever its size, so parameters after a
  whole step would compare rounding signs);
* the data pipeline's tokens, the msgpack subset's bytes and the
  checkpoint files, byte for byte, and each package restoring the other's
  files (a bf16 leaf raises in both);
* ``python -m repro_torch.launch.train --device cpu``.
"""
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.data.pipeline import SyntheticTextDataset as JDataset
from repro.kernels.ref import flash_attention_ref, rmsnorm_ref
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_loss_fn as jmake_loss_fn
from repro.train.loop import make_train_step as jmake_train_step

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import _msgpack
from repro_torch.data import SyntheticTextDataset
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                 flash_attention_plain_lse)
from repro_torch.kernels.rmsnorm import rmsnorm_backward
from repro_torch.launch import train as train_cli
from repro_torch.models import convert, registry
from repro_torch.optim import adamw
from repro_torch.train import (TrainConfig, init_state, make_grad_fn,
                               make_train_step, trainable)
from torch_parity import one_thread_module  # noqa: F401 (one thread)

CPU = {"device": "cpu"}
ARCHS = registry.ARCH_IDS + ["gpt"]      # tests/test_arch_smoke.py's
REL = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# gradient formulas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 128), (2, 16, 256), (3, 5, 64)])
def test_rmsnorm_backward_is_the_vjp(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1:]) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(rmsnorm_ref, jnp.asarray(x), jnp.asarray(s))
    want = vjp(jnp.asarray(dy))
    got = rmsnorm_backward(torch.from_numpy(x), torch.from_numpy(s),
                           torch.from_numpy(dy), 1e-6)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_rmsnorm_backward_keeps_bf16():
    x = torch.randn(4, 64).to(torch.bfloat16)
    s = torch.zeros(64, dtype=torch.bfloat16)
    dx, ds = rmsnorm_backward(x, s, torch.ones_like(x), 1e-6)
    assert dx.dtype == ds.dtype == torch.bfloat16
    assert dx.shape == x.shape and ds.shape == s.shape


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 32, 2, 2, 32), (1, 64, 4, 2, 64),
                                         (1, 24, 4, 1, 128)])
def test_flash_attention_backward_is_the_vjp(B, S, H, KV, hd, causal):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, hd)).astype(np.float32)

    def ref(q, k, v):                     # GQA: KV heads repeated in order
        return flash_attention_ref(q, jnp.repeat(k, H // KV, axis=2),
                                   jnp.repeat(v, H // KV, axis=2),
                                   causal=causal)
    _, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dy))
    got = flash_attention_backward(*map(torch.from_numpy, (q, k, v, dy)),
                                   causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_custom_op_gradients_are_the_vjp(causal):
    """Through ``repro_torch::flash_attention`` and ``repro_torch::rmsnorm``
    under autograd (their backward ops, CPU: the closed forms): fp32
    gradients within 1e-5 of ``jax.vjp``; the forward op keeps the plain
    LSE with the plain output in both dtypes (each route's backward kernel
    reads it on the card), launching nothing."""
    B, S, H, KV, hd = 2, 40, 4, 2, 32
    rng = np.random.default_rng(4)
    q, k, v, dy = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
                   for n in (H, KV, KV, H))
    ops.reset_launch_counts()
    qt, kt, vt = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    out, lse = ops.flash_attention_op(qt, kt, vt, 0, causal, True)
    with torch.no_grad():
        assert torch.equal(lse, flash_attention_plain_lse(
            qt, kt, vt, causal=causal)[1])
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dy))

    def ref(q, k, v):
        return flash_attention_ref(q, jnp.repeat(k, H // KV, axis=2),
                                   jnp.repeat(v, H // KV, axis=2),
                                   causal=causal)
    _, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    qb, kb, vb = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    out, lse = ops.flash_attention_op(qb, kb, vb, 0, causal, True)
    want_out, want_lse = flash_attention_plain_lse(qb, kb, vb, causal=causal)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    sc = (rng.standard_normal(64) * 0.1).astype(np.float32)
    dx = rng.standard_normal((3, 7, 64)).astype(np.float32)
    xt, st = (torch.from_numpy(t).requires_grad_(True) for t in (x, sc))
    got = torch.autograd.grad(ops.rmsnorm_op(xt, st, 1e-6), (xt, st),
                              torch.from_numpy(dx))
    _, vjp = jax.vjp(rmsnorm_ref, jnp.asarray(x), jnp.asarray(sc))
    for g, w in zip(got, vjp(jnp.asarray(dx))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert all(n == 0 for n in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=32):
    """tests/test_arch_smoke.py's batch, as numpy."""
    rng = np.random.default_rng(0)
    batch = {}
    if cfg.family == "vlm":
        vt = cfg.vision_tokens
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S - vt))
        batch["patch_embeds"] = rng.normal(
            size=(B, vt, cfg.d_model)).astype(np.float32)
    elif cfg.family == "audio":
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S))
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S))
    batch["labels"] = rng.integers(0, cfg.vocab, (B, S))
    return batch


def _both(arch):
    """(jax cfg, jax params, port cfg, trainable port model)."""
    jcfg = jregistry.load_config(arch).reduced()
    cfg = registry.load_config(arch).reduced()
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    model = trainable(convert.from_jax(jax.tree.map(np.asarray, jparams),
                                       cfg, **CPU))
    return jcfg, jparams, cfg, model


def _inputs(batch):
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
          for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jb, tb


def _hold_grads(arch, tcfg, jtcfg, B=2):
    jcfg, jparams, cfg, model = _both(arch)
    jb, tb = _inputs(_batch(cfg, B=B))
    if jtcfg.microbatches > 1:        # JAX's accumulate is its train step's
        jgrads, jm = _jax_accumulated(jcfg, jtcfg, jparams, jb)
    else:
        (_, jm), jgrads = jax.value_and_grad(
            jmake_loss_fn(jcfg, jtcfg), has_aux=True)(jparams, jb)
    grads, metrics = make_grad_fn(cfg, tcfg)(model, tb)
    want = convert.state_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert _rel(g.numpy(), want[name]) <= REL, name
    for k in jm:
        assert _rel(metrics[k].numpy(), np.asarray(jm[k])) <= REL, k
    gnorm = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                        for g in want.values()))
    got = torch.sqrt(sum(torch.sum(torch.square(g.double()))
                         for g in grads.values())).item()
    assert _rel(got, gnorm) <= REL


def _jax_accumulated(jcfg, jtcfg, jparams, jb):
    """JAX's microbatch gradient: its train step's ``accumulate``, read
    through the grads it hands AdamW."""
    seen = {}
    real = jadamw.update

    def spy(grads, state, params, cfg):
        seen["grads"] = grads
        return real(grads, state, params, cfg)
    jadamw.update = spy
    try:
        _, _, m = jmake_train_step(jcfg, jtcfg)(
            jparams, jadamw.init(jparams), jb)
    finally:
        jadamw.update = real
    m.pop("grad_norm")
    return seen["grads"], m


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_as_jax(arch):
    _hold_grads(arch, TrainConfig(), JTrainConfig())


def test_gradients_as_jax_microbatches_and_z_loss():
    _hold_grads("gpt", TrainConfig(microbatches=2),
                JTrainConfig(microbatches=2), B=4)
    _hold_grads("mixtral-8x7b", TrainConfig(z_loss=1e-4),
                JTrainConfig(z_loss=1e-4))


@pytest.mark.parametrize("tcfg", [{}, {"microbatches": 2}, {"z_loss": 1e-4}],
                         ids=["plain", "microbatches", "z_loss"])
def test_train_step_as_jax(tcfg):
    """One whole step of gpt: the loss and the gradient norm equal JAX's
    make_train_step's, and the parameters move."""
    jcfg, jparams, cfg, model = _both("gpt")
    jb, tb = _inputs(_batch(cfg, B=4))
    _, _, jm = jmake_train_step(jcfg, JTrainConfig(**tcfg))(
        jparams, jadamw.init(jparams), jb)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw.init(dict(model.named_parameters()))
    _, opt, m = make_train_step(cfg, TrainConfig(**tcfg))(model, opt, tb)
    for k in ("loss", "ce_loss", "grad_norm"):
        assert _rel(m[k].numpy(), np.asarray(jm[k])) <= REL, k
    assert int(opt["step"]) == 1
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())


def _trees(rng, dtype=np.float32):
    shapes = {"a": (4, 8), "b": (8,), "c": (3, 2, 5)}
    params = {k: rng.standard_normal(s).astype(dtype)
              for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * 0.5).astype(dtype)
             for k, s in shapes.items()}
    grads["b"][:] = 0.0                   # a zero gradient leaf
    return params, grads


@pytest.mark.parametrize("cfg", [
    {}, {"clip_norm": 0.0}, {"weight_decay": 0.0}, {"clip_norm": 0.05}],
    ids=["default", "no_clip", "no_decay", "clipped"])
def test_adamw_update_as_jax(cfg):
    """Three steps on the same given gradients: the parameters, both
    moments, the step and the gradient norm equal JAX's."""
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    rng = np.random.default_rng(0)
    params, _ = _trees(rng)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jadamw.init(jp), adamw.init(tp)
    for _ in range(3):
        _, grads = _trees(rng)
        jp, jstate, jg = jadamw.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp, jcfg)
        tp, tstate, tg = adamw.update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, tstate, tp,
            tcfg)
        assert _rel(tg.numpy(), np.asarray(jg)) <= 1e-6
        # float32 rounding, summed in another order, to 1e-6 of each
        # array's scale (a moment element that cancels to ~0 keeps only
        # its absolute error)
        for k in params:
            for got, want in ((tp[k], jp[k]), (tstate["mu"][k],
                                               jstate["mu"][k]),
                              (tstate["nu"][k], jstate["nu"][k])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-6,
                    atol=1e-6 * max(np.abs(want).max(), 1e-30))
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32


def test_adamw_casts_back_to_bf16():
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    state = adamw.init(p)
    assert state["mu"]["w"].dtype == torch.float32
    adamw.update({"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)},
                 state, p, adamw.AdamWConfig())
    assert p["w"].dtype == torch.bfloat16
    assert float(adamw.schedule(adamw.AdamWConfig(), state["step"])) == \
        pytest.approx(3e-6)


@pytest.mark.parametrize("where", ["cpu", "fake", "meta"])
def test_adamw_takes_the_plain_version_off_the_card(monkeypatch, where):
    """CPU tensors, fake tensors (made as the dry run's CPU tests make
    theirs) and meta tensors take the plain version: the kernels' path is
    never entered and no ``adamw_*`` launch is counted; the update still
    runs in place and returns the step's norm. A fake CUDA leaf set would
    keep the plain version too."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import adamw as kadamw

    def refuse(*a, **k):
        raise AssertionError("the kernels' path was taken")
    monkeypatch.setattr(kadamw, "update", refuse)

    def leaves(device):
        return ({"w": torch.zeros(4, 8, dtype=torch.bfloat16, device=device),
                 "b": torch.zeros(8, device=device)},
                {"w": torch.ones(4, 8, device=device),
                 "b": torch.ones(8, device=device)})

    def run(device):
        params, grads = leaves(device)
        state = adamw.init(params)
        _, state, gnorm = adamw.update(grads, state, params,
                                       adamw.AdamWConfig())
        return params, state, gnorm
    ops.reset_launch_counts()
    if where == "fake":
        with FakeTensorMode():
            params, state, gnorm = run("cpu")
            assert not kadamw.takes_kernels(*leaves("cuda"))
    else:
        params, state, gnorm = run(where)
    counts = ops.launch_counts()
    assert counts["adamw_sumsq"] == counts["adamw_update"] == 0
    assert state["step"].shape == () and gnorm.shape == ()
    if where == "cpu":
        assert int(state["step"]) == 1
        assert float(gnorm) == pytest.approx(40 ** 0.5)
        assert bool((params["w"] != 0).all())


def test_adamw_kernel_constants_are_the_plain_scalars():
    """The kernel's constants are the plain version's Python scalars as
    fp32 (``1 - b1`` formed in double, then rounded once), and only plain
    CUDA tensors would take the kernels."""
    from repro_torch.kernels import adamw as kadamw
    cfg = adamw.AdamWConfig()
    a = kadamw.update_args(cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
    for got, want in ((a.b1, cfg.b1), (a.omb1, 1 - cfg.b1), (a.b2, cfg.b2),
                      (a.omb2, 1 - cfg.b2), (a.eps, cfg.eps),
                      (a.wd, cfg.weight_decay)):
        assert got == float(np.float32(want))
    assert a.decay == 1
    assert kadamw.update_args(0.9, 0.95, 1e-8, 0.0).decay == 0
    assert not kadamw.takes_kernels({"w": torch.zeros(2)})


def test_init_state_is_trainable():
    model, opt = init_state(registry.load_config("gpt").reduced(), 0, **CPU)
    assert all(p.requires_grad for p in model.parameters())
    assert set(opt["mu"]) == {n for n, _ in model.named_parameters()}


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shard", [(0, 0), (3, 1)])
def test_pipeline_tokens_as_jax(seed, shard):
    mine = SyntheticTextDataset(vocab=50257, seq_len=64, batch=3, seed=seed,
                                n_shards=2, shard=shard)
    ref = JDataset(vocab=50257, seq_len=64, batch=3, seed=seed, n_shards=2,
                   shard=shard)
    for step in (0, 1, 17):
        got, want = mine.batch_at(step, **CPU), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int64
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_msgpack_subset_is_msgpack():
    objs = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -2**15 - 1, -2**31 - 1, -2**63,
            "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 70000, "é∂",
            b"", b"x" * 255, b"y" * 256, b"z" * 70000, list(range(15)),
            list(range(16)), list(range(70000)), {str(i): i for i in range(15)},
            {str(i): i for i in range(16)},
            {"step": 5, "tensors": {"a/#0": {
                b"dtype": "<f4", b"shape": [2, 3],
                b"data": np.arange(6, dtype=np.float32).tobytes()}}}]
    for obj in objs:
        blob = _msgpack.packb(obj)
        assert blob == msgpack.packb(obj)
        assert _msgpack.unpackb(blob) == \
            msgpack.unpackb(blob, strict_map_key=False)
    with pytest.raises(TypeError):
        _msgpack.packb(1.5)
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")


def _tree(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "sub": {"b": np.arange(5, dtype=np.int32),
                    "list": [rng.standard_normal(2).astype(np.float32),
                             np.float32(2.5)]},
            "i64": np.arange(3, dtype=np.int64)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def test_checkpoints_are_byte_identical_and_cross(tmp_path):
    tree = _tree(np.random.default_rng(0))
    mine = save_checkpoint(str(tmp_path / "port"), 7, _as_torch(tree))
    # numpy leaves: jnp.asarray would narrow the int64 leaf to int32
    ref = jsave(str(tmp_path / "jax"), 7, tree)
    assert os.path.basename(mine) == os.path.basename(ref) == \
        "ckpt_00000007.msgpack"
    assert open(mine, "rb").read() == open(ref, "rb").read()
    assert latest_step(str(tmp_path / "port")) == 7
    assert latest_step(str(tmp_path / "none")) is None
    # each package restores the other's file
    step, got = restore_checkpoint(str(tmp_path / "jax"), 7, _as_torch(tree))
    assert step == 7 and got["sub"]["b"].dtype == torch.int32
    assert np.array_equal(got["w"].numpy(), tree["w"])
    assert np.array_equal(got["sub"]["list"][0].numpy(),
                          tree["sub"]["list"][0])
    step, back = jrestore(str(tmp_path / "port"), 7, tree)
    assert step == 7
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(back), jax.tree.leaves(tree)))


def test_bf16_checkpoint_is_the_jax_file_and_restores_in_neither(tmp_path):
    """A bf16 leaf is written as the JAX package writes it ('<V2'); the JAX
    package's restore fails on it, and so does the port's, with a
    ValueError naming the leaf."""
    x = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    mine = save_checkpoint(str(tmp_path / "port"), 1,
                           {"a": t, "b": torch.ones(2)})
    ref = jsave(str(tmp_path / "jax"), 1,
                {"a": jnp.asarray(x, jnp.bfloat16), "b": jnp.ones(2)})
    assert open(mine, "rb").read() == open(ref, "rb").read()
    with pytest.raises(ValueError, match="No cast function available"):
        jrestore(str(tmp_path / "jax"), 1,
                 {"a": jnp.zeros((2, 3), jnp.bfloat16), "b": jnp.ones(2)})
    with pytest.raises(ValueError, match="leaf `a` is bf16"):
        restore_checkpoint(str(tmp_path / "port"), 1,
                           {"a": t, "b": torch.ones(2)})


def test_model_tree_layout_round_trips():
    """``convert.to_jax`` is ``state_from_jax``'s inverse: the checkpoint's
    tree is the JAX package's."""
    for arch in ("gpt", "recurrentgemma-2b", "whisper-medium"):
        jcfg = jregistry.load_config(arch).reduced()
        cfg = registry.load_config(arch).reduced()
        params = jax.tree.map(np.asarray, jregistry.init_params(
            jcfg, jax.random.PRNGKey(0)))
        back = convert.to_jax(convert.from_jax(params, cfg, **CPU))
        flat = jax.tree_util.tree_flatten_with_path
        want, got = flat(params)[0], flat(back)[0]
        assert [p for p, _ in got] == [p for p, _ in want]
        assert all(np.array_equal(g.numpy(), w)
                   for (_, g), (_, w) in zip(got, want))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_runs_on_the_cpu(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        train_cli.main(["--arch", "gpt", "--steps", "2", "--batch", "2",
                        "--seq", "32", "--device", "cpu",
                        "--ckpt", str(tmp_path)])
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 and lines[0].startswith("step 0 loss ")
    assert np.isfinite(float(lines[0].split()[-1]))
    # the parameters restore in the JAX package, in its tree
    jcfg = jregistry.load_config("gpt").reduced()
    like = {"params": jregistry.init_params(jcfg, jax.random.PRNGKey(0))}
    step, restored = jrestore(str(tmp_path), 2, like)
    assert step == 2
    assert jax.tree.structure(restored) == jax.tree.structure(like)


def test_launch_train_defaults_and_device():
    """The JAX launcher's defaults; the card unless --device cpu."""
    args = train_cli.parser().parse_args([])
    assert (args.arch, args.steps, args.batch, args.seq, args.full,
            args.ckpt, args.device) == ("gpt", 50, 4, 128, False, None, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# tests/test_substrate.py's training checks on the port alone
# ---------------------------------------------------------------------------

def test_loss_decreases_tiny_gpt():
    """30 steps of the reduced gpt on the synthetic stream lower the mean
    loss of the last five below the first five's (JAX's own check)."""
    cfg = registry.load_config("gpt").reduced()
    model = trainable(registry.init_params(cfg, seed=0, **CPU))
    opt = adamw.init(dict(model.named_parameters()))
    step = make_train_step(cfg, TrainConfig(
        optimizer=adamw.AdamWConfig(lr=3e-3, warmup_steps=5)))
    ds = SyntheticTextDataset(vocab=cfg.vocab, seq_len=32, batch=4)
    losses = []
    for i in range(30):
        _, opt, m = step(model, opt, ds.batch_at(i, **CPU))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_grad_accum_matches_full_batch():
    """A step over two microbatches moves the parameters as one over the
    whole batch (rtol 2e-2, atol 2e-3: the JAX test's limits)."""
    cfg = registry.load_config("gpt").reduced()
    batch = SyntheticTextDataset(vocab=cfg.vocab, seq_len=16,
                                 batch=4).batch_at(0, **CPU)
    moved = []
    for mb in (1, 2):
        model = trainable(registry.init_params(cfg, seed=0, **CPU))
        opt = adamw.init(dict(model.named_parameters()))
        make_train_step(cfg, TrainConfig(microbatches=mb))(model, opt, batch)
        moved.append({n: p.detach() for n, p in model.named_parameters()})
    for n, p in moved[0].items():
        np.testing.assert_allclose(moved[1][n].float().numpy(),
                                   p.float().numpy(), rtol=2e-2, atol=2e-3)
