"""Production meshes and divisibility-aware sharding rules.

The JAX package's production meshes, as ``torch.distributed`` device
meshes of H100 ranks: (16, 16) ``("data", "model")`` over 256 ranks and
(2, 16, 16) ``("pod", "data", "model")`` over 512. No machine here has
that many cards, so ``make_production_mesh`` builds them over a fake
process group (every collective a no-op that keeps shapes), which plays
the part of the JAX dry run's 512 host devices: this process is rank 0.
``make_mesh`` builds a real mesh over the process group that is
initialized (on one card, (1, 1) over a one-rank NCCL group).

Importing this module starts no process group and sets no variable.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..models.config import ModelConfig
from ..sharding.specs import ShardingRules, default_rules

POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_fake_mesh(shape, axes, device: str = "cuda"):
    """A mesh of ``prod(shape)`` ranks over a fake process group, this
    process rank 0: tensors are this rank's shards, collectives move
    nothing. Replaces the process group that is initialized."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: (16, 16) (data, model) = 256 ranks.
    Multi-pod: (2, 16, 16) (pod, data, model) = 512 ranks. Both over a
    fake process group (see the module docstring)."""
    shape, axes = MULTI_POD if multi_pod else POD
    return make_fake_mesh(shape, axes, device)


def make_mesh(shape, axes, device: str = "cuda"):
    """A mesh over the process group that is initialized, whose world size
    must be ``prod(shape)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def rules_for_config(cfg: ModelConfig, mesh,
                     base: ShardingRules | None = None) -> ShardingRules:
    """Adapt the default rules to the architecture: any logical dim not
    divisible by its mesh axis falls back to replication (e.g. 10 heads on a
    16-way model axis). This keeps every assigned arch lowerable on the
    production mesh without per-arch hand tuning."""
    rules = base or default_rules(multi_pod="pod" in mesh.mesh_dim_names)
    model_n = mesh_axis_size(mesh, "model")
    data_n = mesh_axis_size(mesh, "data")

    def ok(dim_size, n):
        return dim_size % n == 0 and dim_size >= n

    upd = {}
    if not ok(cfg.n_heads, model_n):
        # replicate attention heads when they don't divide the TP axis —
        # a fused (H*hd) fallback misaligns head boundaries and forces
        # involuntary resharding inside the attention einsums.
        upd["heads"] = None
        upd["act_heads"] = None
    if not ok(cfg.n_kv_heads, model_n):
        upd["kv_heads"] = None
    if cfg.d_ff and not ok(cfg.d_ff, model_n):
        upd["ff"] = None
        upd["act_ff"] = None
    if cfg.vocab % model_n:
        upd["vocab"] = None
    if cfg.n_experts and not ok(cfg.n_experts, model_n):
        upd["experts"] = None
    if cfg.n_experts and ok(cfg.moe_d_ff, data_n):
        upd["expert_fsdp"] = "data"
    # Parameter sharding plan: ZeRO-1 by default (params model-sharded,
    # replicated over data; optimizer state sharded over data — see
    # build_train). Full FSDP (params' embed dim over data) only when the
    # model-sharded params alone exceed half of HBM, because XLA's SPMD
    # backward for FSDP-sharded weights all-gathers batch activations
    # (measured in EXPERIMENTS.md SPerf).
    from ..models import registry as _registry
    param_gib = _registry.n_params(cfg) * 2 / 2**30
    if param_gib / max(model_n, 1) < 8.0:
        upd["embed_fsdp"] = None
        upd["expert_fsdp"] = None
    if cfg.d_model % data_n:
        upd["embed_fsdp"] = None
    # ssm/hybrid channel dims
    if cfg.family == "ssm":
        ch = cfg.d_inner + 2 * cfg.ssm_state
        if ch % model_n or (cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads) % model_n:
            upd["heads"] = None
        if not ok(cfg.ssm_heads, model_n):
            upd.setdefault("heads", None)
    if cfg.family == "hybrid" and cfg.lru_width % model_n:
        upd["ff"] = None
        upd["act_ff"] = None
    return rules.with_(**upd)
