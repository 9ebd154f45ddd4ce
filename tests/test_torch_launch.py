"""The port's launch tooling (repro_torch.launch.{mesh,inputs}, the mesh
part of sharding/specs.py, registry.abstract_params) against the JAX
package, on the CPU.

Rules, input shapes, stand-ins and logical trees are compared exactly for
all 11 configs. Rank 0's shard of every parameter on the fake (16, 16)
and (2, 16, 16) meshes (a fake process group, torn down after the test)
must have JAX's shard shape from the same rules and spec. A 4-rank gloo
run (a subprocess, ``tests/torch_mesh_worker.py``) holds the sharded
forward against the unsharded one, and ``remat`` must leave every
gradient as it was.
"""
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.launch import inputs as jinputs
from repro.launch import mesh as jmesh
from repro.models import config as jconfig
from repro.models import registry as jreg
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import config as tconfig
from repro_torch.models import convert
from repro_torch.models import registry as treg
from repro_torch.sharding import specs as tspecs
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = treg.ARCH_IDS + ["gpt"]
SHAPES = list(tconfig.INPUT_SHAPES)
MESHES = {"pod": tmesh.POD, "multipod": tmesh.MULTI_POD}


def _jax_mesh(shape, axes):
    """What the JAX rules read of a mesh: its axis names and shape."""
    return SimpleNamespace(axis_names=tuple(axes),
                           devices=SimpleNamespace(shape=tuple(shape)))


def _torch_mesh(shape, axes):
    return SimpleNamespace(mesh_dim_names=tuple(axes), shape=tuple(shape))


def _mesh_shapes(cfg, which):
    if which != "factored":
        return MESHES[which]
    e = cfg.n_experts if cfg.n_experts and cfg.n_experts < 16 \
        and 16 % cfg.n_experts == 0 else 8
    return (16, e, 16 // e), ("data", "expert", "model")


def test_input_shapes_are_the_jax_packages():
    assert list(tconfig.INPUT_SHAPES) == list(jconfig.INPUT_SHAPES)
    for name, s in tconfig.INPUT_SHAPES.items():
        j = jconfig.INPUT_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.mode) == \
            (j.name, j.seq_len, j.global_batch, j.mode)


@pytest.mark.parametrize("which", ["pod", "multipod", "factored"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_config_are_the_jax_packages(arch, which):
    tcfg, jcfg = treg.load_config(arch), jreg.load_config(arch)
    shape, axes = _mesh_shapes(tcfg, which)
    t = tmesh.rules_for_config(tcfg, _torch_mesh(shape, axes))
    j = jmesh.rules_for_config(jcfg, _jax_mesh(shape, axes))
    if which == "factored":
        t, j = t.with_(experts="expert"), j.with_(experts="expert")
    assert t.rules == j.rules
    assert tmesh.mesh_axis_size(_torch_mesh(shape, axes), "model") == \
        jmesh.mesh_axis_size(_jax_mesh(shape, axes), "model")


def _abstract_jax_state(cfg):
    """The JAX abstract tree as the port's flat {name: array} through
    convert's names; each leaf a zero-stride numpy view (no memory)."""
    tree = jax.tree.map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, dtype=s.dtype), s.shape, (0,) * len(s.shape)),
        jreg.abstract_params(cfg))
    return convert.state_from_jax(tree, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_are_the_jax_packages(arch):
    model = treg.abstract_params(treg.load_config(arch))
    want = _abstract_jax_state(jreg.load_config(arch))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert p.device.type == "meta", name
        assert tuple(p.shape) == want[name].shape, name
        assert str(p.dtype).removeprefix("torch.") == str(want[name].dtype), \
            name


def _spec(t):
    return (tuple(t.shape), str(t.dtype).removeprefix("torch."))


def _jspec(s):
    return (tuple(s.shape), str(s.dtype))


def _jax_cache_as_port(cfg, jcache, jlogical):
    """The JAX cache (stacked by pattern position) and its logical tree
    as the port's per-layer structure: (spec, axes) leaves."""
    def leaf(s, axes, g):
        if g is None:
            return (_jspec(s), tuple(axes))
        assert axes[0] == "layers"
        return ((tuple(s.shape[1:]), str(s.dtype)), tuple(axes[1:]))

    fam = cfg.family
    L = cfg.n_layers
    if fam == "ssm":
        return [(leaf(jcache["ssm_state"], jlogical["ssm_state"], l),
                 leaf(jcache["conv_state"], jlogical["conv_state"], l))
                for l in range(L)]
    if fam == "audio":
        pair = lambda a, b: (leaf(jcache[a], jlogical[a], 0),  # noqa: E731
                             leaf(jcache[b], jlogical[b], 0))
        return {"self": [pair("self_k", "self_v")] * L,
                "cross": [pair("cross_k", "cross_v")] * L}
    P = len(cfg.pattern)
    reps = L // P
    out = []
    for layer in range(L):
        g, i = divmod(layer, P)
        key, stacked = (f"p{i}", g) if g < reps else (f"tail{i}", None)
        c, ax = jcache[key], jlogical[key]
        if isinstance(c, dict):
            out.append({k: leaf(c[k], ax[k], stacked) for k in c})
        else:
            out.append(tuple(leaf(a, b, stacked) for a, b in zip(c, ax)))
    return out


def _port_cache(tcache, tlogical):
    if isinstance(tcache, torch.Tensor):
        return (_spec(tcache), tuple(tlogical))
    if isinstance(tcache, dict):
        return {k: _port_cache(v, tlogical[k]) for k, v in tcache.items()}
    return type(tcache)(_port_cache(v, a) for v, a in zip(tcache, tlogical))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_logical_trees_are_the_jax_packages(arch, shape):
    tcfg, jcfg = treg.load_config(arch), jreg.load_config(arch)
    ts, js = tconfig.INPUT_SHAPES[shape], jconfig.INPUT_SHAPES[shape]
    assert tinputs.skip_reason(tcfg, ts) == jinputs.skip_reason(jcfg, js)
    if tinputs.skip_reason(tcfg, ts):
        return
    assert tinputs.batch_logical(tcfg, ts) == jinputs.batch_logical(jcfg, js)
    if ts.mode in ("train", "prefill"):
        t = tinputs.input_specs(tcfg, ts)
        j = jinputs.input_specs(jcfg, js)
        assert {k: _spec(v) for k, v in t.items()} == \
            {k: _jspec(v) for k, v in j.items()}
        assert all(v.device.type == "meta" for v in t.values())
        return
    tcache, ttok, tpos = tinputs.decode_specs(tcfg, ts)
    jcache, jtok, jpos = jinputs.decode_specs(jcfg, js)
    assert _spec(ttok) == _jspec(jtok) and _spec(tpos) == _jspec(jpos)
    assert _port_cache(tcache, tinputs.cache_logical(tcfg)) == \
        _jax_cache_as_port(jcfg, jcache, jinputs.cache_logical(jcfg))
    assert tspecs.tree_map_axes(lambda a: a, tinputs.cache_logical(tcfg)) \
        == tinputs.cache_logical(tcfg)


def test_make_batch_specs_is_input_specs():
    from repro_torch.data import pipeline
    cfg, shape = treg.load_config("gpt"), tconfig.INPUT_SHAPES["train_4k"]
    got = pipeline.make_batch_specs(cfg, shape)
    assert {k: _spec(v) for k, v in got.items()} == \
        {k: _spec(v) for k, v in tinputs.input_specs(cfg, shape).items()}


@pytest.fixture
def fake_mesh():
    """A fake production mesh, torn down after the test."""
    made = []

    def make(which):
        made.append(tmesh.make_production_mesh(
            multi_pod=which == "multipod", device="cpu"))
        return made[-1]

    yield make
    if made:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("which", ["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_shards_have_the_jax_shard_shapes(fake_mesh, arch, which):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    mesh = fake_mesh(which)
    shape, axes = MESHES[which]
    assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes
    tcfg, jcfg = treg.load_config(arch), jreg.load_config(arch)
    rules = tmesh.rules_for_config(tcfg, mesh)
    jrules = jmesh.rules_for_config(jcfg, _jax_mesh(shape, axes))
    assert rules.rules == jrules.rules
    jm = AbstractMesh(shape, axes)
    abstract = jreg.abstract_params(jcfg)
    jlogical = jreg.logical_axes(jcfg)
    jshard = jax.tree.map(
        lambda s, ax: np.lib.stride_tricks.as_strided(
            np.zeros(1, dtype=s.dtype),
            NamedSharding(jm, jrules.spec_for(ax)).shard_shape(s.shape),
            (0,) * len(s.shape)),
        abstract, jlogical, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
    want = convert.state_from_jax(jshard, jcfg)
    with FakeTensorMode():
        model = tspecs.distribute_params(treg.abstract_params(tcfg), mesh,
                                         rules, device="cpu")
        params = dict(model.named_parameters())
        got = {n: tuple(p.to_local().shape) for n, p in params.items()}
        mem_args = dryrun._unique_bytes(list(params.values()))
    assert got == {n: a.shape for n, a in want.items()}
    assert mem_args == sum(math.prod(a.shape) * a.dtype.itemsize
                           for a in want.values())


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert tspecs.constrain(x, ("batch", "seq", "embed")) is x
    rules = tspecs.default_rules()
    with tspecs.use_sharding(None, rules):
        assert tspecs.active_mesh() is None
        assert tspecs.constrain(x, ("batch", None, "vocab")) is x
    # a mesh but a plain tensor: still the identity
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    tspecs._ctx.mesh, tspecs._ctx.rules = mesh, rules
    try:
        assert tspecs.constrain(x, ("batch", None, "vocab")) is x
    finally:
        tspecs._ctx.mesh, tspecs._ctx.rules = None, None


@pytest.mark.parametrize("spec,want", [
    ((("pod", "data"), None, "model"), "S0 S0 S2"),
    (("data", "model"), "R S0 S1"),
    ((None, None), "R R R"),
    (("model",), "R R S0"),
])
def test_placements_for_follows_the_mesh_order(spec, want):
    from repro_torch.core.spmd import PartitionSpec
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    got = tspecs.placements_for(mesh, PartitionSpec(*spec))
    assert " ".join(f"S{p.dim}" if p.is_shard() else "R" for p in got) \
        == want


def test_placements_for_rejects_an_axis_out_of_mesh_order():
    from repro_torch.core.spmd import PartitionSpec
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh's order"):
        tspecs.placements_for(mesh, PartitionSpec(("data", "pod")))


# forward at dp2 x tp2 (gpt, mixtral; yi-9b cut to 1 KV head, the GQA case
# where KV does not divide the model axis), and every family's gradients
GLOO_CASES = ["gpt", "mixtral-8x7b", "yi-9b:kv1", "gpt+grad",
              "mixtral-8x7b+grad", "mamba2-1.3b+grad", "recurrentgemma-2b+grad",
              "whisper-medium+grad", "yi-9b:kv1+grad"]


@pytest.fixture(scope="module")
def gloo_errors():
    """One 4-rank gloo run (a subprocess) of every case."""
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
         *GLOO_CASES], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return dict((case, float(err)) for case, err in (
        line.split(" max_abs_err=") for line in r.stdout.splitlines()
        if " max_abs_err=" in line))


@pytest.mark.parametrize("case", GLOO_CASES)
def test_gloo_dp2xtp2_is_the_unsharded_model(gloo_errors, case):
    """4 gloo ranks: the reduced fp32 model with DTensor parameters at
    dp2 x tp2 gives the unsharded forward's logits (or, +grad, the
    training loss's gradients of every parameter) within 1e-5."""
    assert gloo_errors[case] <= 1e-5, gloo_errors


REMAT_ARCHS = ["gpt", "mixtral-8x7b", "mamba2-1.3b", "recurrentgemma-2b",
               "whisper-medium"]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_leaves_the_gradients_as_they_were(arch):
    """cfg.remat (a per-block torch.utils.checkpoint) on and off give the
    same gradients for each of the five families, fp32, within 1e-6."""
    from repro_torch.train.loop import make_grad_fn, trainable
    cfg = treg.load_config(arch).reduced()
    g = torch.Generator().manual_seed(0)
    S = 16
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, S), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, S), generator=g)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encoder_frames, cfg.d_model),
                                      generator=g)
    grads = []
    for remat in (False, True):
        c = cfg.__class__(**{**cfg.__dict__, "remat": remat})
        model = trainable(treg.init_params(c, seed=0, device="cpu"))
        grads.append(make_grad_fn(c)(model, batch)[0])
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        assert torch.allclose(grads[0][n], grads[1][n], rtol=0, atol=1e-6), n
