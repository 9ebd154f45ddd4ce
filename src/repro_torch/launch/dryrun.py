"""Multi-pod dry run: trace every (arch x input-shape x mesh) combination
on fake tensors over a fake 256- or 512-rank mesh, count its per-device
cost, memory and collectives, and derive the three-term roofline.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh pod|multipod|both] [--outdir D] [--skip-probes]
        [--device cuda|cpu]

Each combination runs the port's own train step, prefill or
``decode_step`` eagerly under ``FakeTensorMode`` (shapes and dtypes, no
memory, no kernel launch), with DTensor parameters, inputs and optimizer
state placed on ``launch.mesh.make_production_mesh``'s fake process group
by the rules of ``rules_for_config``; this process is rank 0. The mesh
names ``pod16x16`` and ``pod2x16x16`` are the JAX package's, so that the
two packages' records line up; here they mean 256 and 512 H100 ranks.
``--device cuda`` (the default) makes fake CUDA tensors and raises without
a CUDA device; ``--device cpu`` makes fake CPU tensors (the tests).

Every number comes from rank 0's local ops, seen by a dispatch mode under
DTensor (``_Trace``): ``flops`` from ``torch.utils.flop_counter``'s
formulas (the kernels' custom ops carry their own), ``bytes_accessed`` the
sum of each op's input and output bytes (an unfused upper bound of XLA's
fused count), ``collective_bytes`` each ``c10d_functional`` collective's
output bytes under the JAX names, ``mem_temp`` the peak of live bytes
allocated during the trace, less the outputs', ``mem_alias`` the outputs
that share storage with donated inputs (parameters and optimizer state
updated in place, the decode cache written in place). The global-shape ops
DTensor runs to propagate shapes are not rank 0's work and are not counted.

The JAX dry run compiles unrolled probe configs and extrapolates, because
XLA's cost analysis counts a ``while`` (scan) body once. An eager trace
counts every layer, so there is nothing to correct: ``extrapolated`` is
the full trace's counts, and ``--skip-probes`` is accepted and has no
effect.

The roofline's constants are the H100 SXM5 80GB data sheet's, not
measurements (``PEAK_FLOPS``, ``HBM_BW``, ``HBM_CAP``, ``LINK_BW``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from dataclasses import replace

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..models import registry
from ..models.config import INPUT_SHAPES, InputShape, ModelConfig
from ..sharding.specs import (distribute, distribute_params, placements_for,
                              use_sharding)
from ..train.loop import TrainConfig, make_train_step
from . import inputs as I
from .mesh import (make_fake_mesh, make_production_mesh, mesh_axis_size,
                   rules_for_config)

# H100 SXM5 80GB data sheet (per GPU), not measurements
PEAK_FLOPS = 989e12          # bf16 tensor cores, dense
HBM_BW = 3.35e12             # bytes/s, HBM3
HBM_CAP = 80 * 2**30         # 80 GB of HBM3
# The 16-wide model axis spans two 8-GPU NVLink nodes, so its slowest link
# is one 400 Gb/s InfiniBand NDR port per GPU (NVLink 4 inside a node gives
# 450 GB/s per direction).
LINK_BW = 50e9               # bytes/s

# c10d_functional (and DTensor's own) collectives under the JAX names;
# any other keeps its own
COLLECTIVES = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
               ("reduce_scatter", "reduce-scatter"),
               ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "detach", "alias", "lift_fresh"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _collective(func):
    if func.namespace not in ("_c10d_functional", "c10d_functional",
                              "_dtensor"):
        return None
    name = func._opname
    if name == "wait_tensor":
        return None
    return next((kind for key, kind in COLLECTIVES if key in name), name)


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _key(t) -> int:
    return _local(t).untyped_storage()._cdata


class _Trace(TorchDispatchMode):
    """Rank 0's local ops, counted. An op on DTensors is passed on
    (``NotImplemented``) to DTensor, whose local ops come back here; ops
    DTensor runs at global shapes to propagate metadata (``shadow``) are
    run and not counted."""

    def __init__(self, known):
        super().__init__()
        self.flops = 0
        self.by_op = {}               # flops by op ("aten.mm", ...)
        self.bytes = 0
        self.coll = {}
        self.known = set(known)       # storages that exist before the trace
        self.tracked = set()
        self.live = 0
        self.peak = 0
        self.shadow = 0

    def _free(self, key, n):
        self.tracked.discard(key)
        self.live -= n

    def _alloc(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self.tracked:
            return
        n = st.nbytes()
        self.tracked.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.shadow:
            return func(*args, **kwargs)
        flat = pytree.tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        kind = _collective(func)
        if kind:
            self.coll[kind] = self.coll.get(kind, 0) \
                + sum(_nbytes(o) for o in outs)
        elif outs and not func.is_view and func._opname not in _FREE:
            packet = func.overloadpacket
            if packet in flop_registry:
                n = flop_registry[packet](*args, **kwargs, out_val=out)
                self.flops += n
                name = f"{func.namespace}.{func._opname}"
                self.by_op[name] = self.by_op.get(name, 0) + n
            self.bytes += sum(_nbytes(a) for a in flat
                              if isinstance(a, torch.Tensor)) \
                + sum(_nbytes(o) for o in outs)
        for o in outs:
            self._alloc(o)
        return out


class _HideShadowOps:
    """Mark the ops DTensor's sharding propagation runs on global-shape
    fake tensors (``ShardingPropagator._propagate_tensor_meta*``), so
    that ``_Trace`` does not count them as rank 0's."""

    def __init__(self, trace: _Trace):
        self.trace = trace
        self.prop = DTensor._op_dispatcher.sharding_propagator
        self.name = next(n for n in ("_propagate_tensor_meta_non_cached",
                                     "_propagate_tensor_meta")
                         if hasattr(self.prop, n))

    def __enter__(self):
        orig = getattr(self.prop, self.name)
        trace = self.trace

        def hidden(*a, **k):
            trace.shadow += 1
            try:
                return orig(*a, **k)
            finally:
                trace.shadow -= 1

        setattr(self.prop, self.name, hidden)
        return self

    def __exit__(self, *exc):
        delattr(self.prop, self.name)


# ---------------------------------------------------------------------------
# Step builders: (fn, args, donated), every tensor a DTensor of fake shards
# ---------------------------------------------------------------------------

def _place(spec_tree, axes_tree, mesh, rules, device):
    """The stand-ins of a tree (meta tensors) as DTensors placed by the
    matching tree of logical axes."""
    if isinstance(spec_tree, torch.Tensor):
        return distribute(spec_tree, mesh,
                          placements_for(mesh, rules.spec_for(axes_tree)),
                          device)
    if isinstance(spec_tree, dict):
        return {k: _place(v, axes_tree[k], mesh, rules, device)
                for k, v in spec_tree.items()}
    return type(spec_tree)(_place(v, a, mesh, rules, device)
                           for v, a in zip(spec_tree, axes_tree))


def _model(cfg, mesh, rules, device, trainable=False):
    model = distribute_params(registry.abstract_params(cfg), mesh, rules,
                              device)
    for p in model.parameters():
        p.requires_grad_(trainable)
    return model


def _batch(cfg, shape, mesh, rules, device):
    return _place(I.batch_specs(cfg, shape), I.batch_logical(cfg, shape),
                  mesh, rules, device)


def build_train(cfg: ModelConfig, shape: InputShape, mesh, rules, device):
    cfg = replace(cfg, remat=True)   # layer-granularity activation ckpt
    # sequence-parallel residual storage (Korthikanti et al. '22): the
    # between-block activations shard their seq dim over the model axis so
    # per-layer checkpoints are not replicated across TP ranks.
    if os.environ.get("REPRO_SP_RESIDUAL", "1") == "1" \
            and shape.seq_len % 16 == 0:
        rules = rules.with_(seq="model")
    step = make_train_step(cfg, TrainConfig())
    model = _model(cfg, mesh, rules, device, trainable=True)
    # ZeRO-1: moments shard their embed dim over data even when params
    # stay replicated across the data axis.
    opt_rules = rules.with_(embed_fsdp="data") \
        if cfg.d_model % mesh_axis_size(mesh, "data") == 0 else rules
    leaves = {f"{mn}.{n}" if mn else n: lf
              for mn, mod in model.named_modules()
              for n, lf in getattr(mod, "leaves", {}).items()}

    def moments():
        return {n: distribute(
            I.sds(p.shape, torch.float32), mesh,
            placements_for(mesh, opt_rules.spec_for(leaves[n].logical)),
            device) for n, p in model.named_parameters()}

    opt = {"mu": moments(), "nu": moments(),
           "step": distribute(I.sds(()), mesh, (Replicate(),) * mesh.ndim,
                              device)}
    batch = _batch(cfg, shape, mesh, rules, device)

    def fn():
        with use_sharding(mesh, rules):
            model_, opt_, metrics = step(model, opt, batch)
        return list(model_.parameters()), opt_, metrics

    return fn, (list(model.parameters()), opt, batch), \
        (list(model.parameters()), opt)


def build_prefill(cfg: ModelConfig, shape: InputShape, mesh, rules, device):
    model = _model(cfg, mesh, rules, device)
    batch = _batch(cfg, shape, mesh, rules, device)

    @torch.no_grad()
    def fn():
        with use_sharding(mesh, rules):
            logits, _ = registry.forward(model, batch)
            return logits

    return fn, (list(model.parameters()), batch), ()


def build_decode(cfg: ModelConfig, shape: InputShape, mesh, rules, device):
    # tiny global batches (long_500k B=1) cannot shard over data
    data_total = mesh_axis_size(mesh, "data") * mesh_axis_size(mesh, "pod")
    if shape.global_batch % data_total:
        rules = rules.with_(batch=None)
    # SPerf iteration (hillclimb): when KV heads cannot shard over the model
    # axis, shard the cache *sequence* dim instead (ring-context parallel) —
    # otherwise the KV cache replicates across all 16 TP ranks.
    if os.environ.get("REPRO_DECODE_SEQ_SHARD", "0") == "1":
        rules = rules.with_(kv_seq="model")
    cache_specs, tok, _ = I.decode_specs(cfg, shape)
    model = _model(cfg, mesh, rules, device)
    cache = _place(cache_specs, I.cache_logical(cfg), mesh, rules, device)
    token = _place(tok, ("batch", None), mesh, rules, device)
    # the position is a Python int in the port's decode_step: the last
    # slot, attending over the whole cache
    pos = shape.seq_len - 1

    @torch.no_grad()
    def fn():
        with use_sharding(mesh, rules):
            return registry.decode_step(model, cache, token, pos)

    return fn, (list(model.parameters()), cache, token), (cache,)


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


# ---------------------------------------------------------------------------
# Trace + analyze
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _unique_bytes(ts, skip=()) -> int:
    seen, n = set(skip), 0
    for t in ts:
        st = _local(t).untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


def count(fn, args, donated=()):
    """Run ``fn()`` (under the caller's ``FakeTensorMode``) once and count
    its local work: ``(record, trace)``, the record in the JAX keys,
    ``args`` and ``donated`` the trees of its inputs and of the inputs its
    outputs may alias."""
    arg_ts = _tensors(args)
    trace = _Trace(_key(t) for t in arg_ts)
    t0 = time.perf_counter()
    with trace, _HideShadowOps(trace):
        out = fn()
    t_trace = time.perf_counter() - t0
    out_ts = _tensors(out)
    donated_keys = {_key(t) for t in _tensors(donated)}
    arg_keys = {_key(t) for t in arg_ts}
    fresh = [t for t in out_ts if _key(t) not in arg_keys]
    return {
        "flops": float(trace.flops),
        "bytes_accessed": float(trace.bytes),
        "collective_bytes": dict(trace.coll),
        "mem_args": _unique_bytes(arg_ts),
        "mem_out": _unique_bytes(out_ts),
        "mem_temp": max(0, trace.peak - _unique_bytes(fresh)),
        "mem_alias": _unique_bytes(
            [t for t in out_ts if _key(t) in donated_keys]),
        "t_trace_s": round(t_trace, 2),
    }, trace


def trace_and_analyze(cfg, shape, mesh, rules, device="cuda"):
    """Run the combination's step once under ``FakeTensorMode`` and count
    rank 0's local work (see the module docstring)."""
    with FakeTensorMode():
        return count(*BUILDERS[shape.mode](cfg, shape, mesh, rules,
                                           device))[0]


def roofline(cfg: ModelConfig, shape: InputShape, est: dict, full: dict,
             n_chips: int) -> dict:
    """All quantities from rank 0's local ops; terms in seconds, against
    the data sheet's constants."""
    t_comp = est["flops"] / PEAK_FLOPS
    t_mem = est["bytes_accessed"] / HBM_BW
    coll_total = sum(est["collective_bytes"].values())
    t_coll = coll_total / LINK_BW
    dom = max(("compute", t_comp), ("memory", t_mem), ("collective", t_coll),
              key=lambda kv: kv[1])
    n_active = registry.n_active_params(cfg)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6 * n_active * tokens
    elif shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2 * n_active * tokens
    else:
        model_flops = 2 * n_active * shape.global_batch
    hlo_total = est["flops"] * n_chips
    return {
        "compute_s": t_comp,
        "memory_s": t_mem,
        "collective_s": t_coll,
        "dominant": dom[0],
        "model_flops": model_flops,
        "hlo_flops_global": hlo_total,
        "useful_ratio": model_flops / hlo_total if hlo_total else 0.0,
        "mem_per_device_gib": (full["mem_args"] + full["mem_temp"]
                               + full["mem_out"] - full["mem_alias"])
        / 2**30,
        "fits_hbm": (full["mem_args"] + full["mem_temp"]) <= HBM_CAP,
    }


def run_combo(arch: str, shape_name: str, multi_pod: bool, outdir: str,
              rules_override=None, tag: str = "", skip_probes: bool = False,
              device: str = "cuda", cfg: ModelConfig = None):
    """One combination's record, written to ``outdir`` as the JAX package
    writes it (``cfg`` overrides the registered config, e.g. a reduced
    one)."""
    cfg = cfg or registry.load_config(arch)
    shape = INPUT_SHAPES[shape_name]
    reason = I.skip_reason(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    key = f"{arch}_{shape_name}_{mesh_name}{tag}"
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, key + ".json")
    if reason:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "skipped": reason}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[skip] {key}: {reason}")
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    # SPerf (mixtral iteration): factor the 16-way model axis into
    # (expert=8) x (model=2) so 8 experts shard instead of replicating.
    if os.environ.get("REPRO_MOE_FACTORED", "0") == "1" and cfg.n_experts \
            and cfg.n_experts < 16 and 16 % cfg.n_experts == 0:
        e = cfg.n_experts
        mshape = (2, 16, e, 16 // e) if multi_pod else (16, e, 16 // e)
        axes = ("pod", "data", "expert", "model") if multi_pod \
            else ("data", "expert", "model")
        mesh = make_fake_mesh(mshape, axes, device)
        base = rules_for_config(cfg, mesh)
        rules_override = base.with_(experts="expert")
    rules = rules_override or rules_for_config(cfg, mesh)
    n_chips = mesh.size()
    print(f"[dryrun] {key} ...", flush=True)
    full = trace_and_analyze(cfg, shape, mesh, rules, device)
    est = {k: full[k] for k in ("flops", "bytes_accessed", "collective_bytes")}
    roof = roofline(cfg, shape, est, full, n_chips)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "n_chips": n_chips, "full_compile": full, "extrapolated": est,
           "roofline": roof}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"  flops/dev={est['flops']:.3e} bytes/dev={est['bytes_accessed']:.3e}"
          f" (unfused upper bound) "
          f"coll/dev={sum(est['collective_bytes'].values()):.3e} "
          f"dom={roof['dominant']} mem={roof['mem_per_device_gib']:.2f}GiB "
          f"fits_hbm={roof['fits_hbm']} (trace {full['t_trace_s']}s)",
          flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--skip-probes", action="store_true",
                    help="accepted for the JAX CLI's sake; an eager trace "
                         "needs no probes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the fake tensors (cuda needs a GPU)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the dry run makes "
                           "fake CUDA tensors unless run with --device cpu")
    archs = [args.arch] if args.arch else registry.ARCH_IDS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    failed = skipped = n = 0
    t0 = time.perf_counter()
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    n += 1
                    try:
                        rec = run_combo(arch, shape, mp, args.outdir,
                                        skip_probes=args.skip_probes,
                                        device=args.device)
                        skipped += "skipped" in rec
                    except Exception as e:  # noqa: BLE001 — report, go on
                        failed += 1
                        traceback.print_exc()
                        print(f"[FAIL] {arch} {shape} mp={mp}: "
                              f"{type(e).__name__}: {e}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[dryrun] {n} combos ({skipped} skipped, {failed} failed) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
