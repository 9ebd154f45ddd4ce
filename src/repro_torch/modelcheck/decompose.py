"""Model decomposer: (config, plan) -> ordered per-block obligations.

``decompose`` walks a model's block structure — embedding, one obligation
per transformer/MoE layer (cycling the config's attention ``pattern``),
head — and derives every obligation's ``in_specs`` from the plan's
``PartitionSpec``s, with block *k*'s activation output spec chained as
block *k+1*'s activation input spec (the seam contract ``stitch`` checks
against each block's inferred R_o).

Obligations land in an :class:`ObligationSet`, which canonicalizes by
structure rather than layer index: GPT's 12 identical layers cost one
verification; gemma3's 5:1 local:global pattern yields two distinct layer
obligations.  An injected bug (``bug="wrong_spec"``, ``bug_layer=k``)
changes layer *k*'s fingerprint, so it splits out of its dedup class and
is verified (and localized) separately.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

from ..models.config import ModelConfig
from ..models.registry import ARCH_IDS, load_config, resolve_device
from ..sharding.specs import MeshPlan, parse_plan
from .blocks import (BlockBuildError, embed_obligation, head_obligation,
                     layer_obligation)
from .obligations import ObligationSet

# family -> support level (None = not yet decomposable).  "backbone" means
# the language backbone is verified and the stubbed frontend (vision/audio)
# is out of scope for the refinement check.
FAMILY_SUPPORT = {
    "dense": "full",
    "moe": "full",
    "vlm": "backbone",
    "ssm": None,        # cross-rank prefix scans need a cumsum lemma family
    "hybrid": None,     # RG-LRU recurrence, same limitation
    "audio": None,      # encoder-decoder frontend
}

# why each unsupported family is unsupported — surfaced in the
# ModelCheckError so the CLI user learns the actual blocker, not just
# the verdict
FAMILY_BLOCKERS = {
    "ssm": "cross-rank prefix scans need a cumsum lemma family",
    "hybrid": "the RG-LRU recurrence needs the same cross-rank scan lemmas",
    "audio": "the encoder-decoder cross-attention frontend is not "
             "block-decomposable yet",
}

BUGS = ("wrong_spec",)


class ModelCheckError(ValueError):
    pass


def list_model_ids() -> Tuple[str, ...]:
    """Every config id ``repro_torch.models.registry.load_config`` takes."""
    return ("gpt",) + tuple(ARCH_IDS)


def supported_models() -> Tuple[str, ...]:
    out = []
    for mid in list_model_ids():
        if FAMILY_SUPPORT.get(load_config(mid).family):
            out.append(mid)
    return tuple(out)


@dataclass
class Decomposition:
    """The block sequence of one (model, plan) pair, deduplicated."""
    model: str
    cfg: ModelConfig
    plan: MeshPlan
    obset: ObligationSet
    bug: Optional[str] = None
    bug_layer: Optional[int] = None
    device: Optional[str] = None         # where the block constants live

    @property
    def total_blocks(self) -> int:
        return self.obset.total_blocks

    @property
    def n_unique(self) -> int:
        return self.obset.n_unique

    @property
    def dedup_ratio(self) -> float:
        return self.obset.dedup_ratio

    def sequential_chain(self):
        """Capture the whole sequential model as a named-block sequence
        (``repro_torch.core.capture.capture_chain``) on the decomposition's
        device: each block's graph reads the previous block's
        ``{name}.out*`` tensors, giving the report its whole-model G_s
        operator count without one opaque model trace."""
        from ..core import capture_chain
        stages = []
        first = None
        for name, key in self.obset.blocks:
            ob = self.obset.unique[key]
            if first is None:
                first = ob
            # carry is the activation (input 0); params are the rest
            stages.append((name, ob.seq_fn, list(ob.avals[1:]),
                           list(ob.input_names[1:])))
        init_avals = [first.avals[0]]
        init_names = [first.input_names[0]]
        return capture_chain(stages, init_avals, init_names,
                             device=self.device)


def _resolve(model: Union[str, ModelConfig],
             plan: Union[str, MeshPlan]) -> Tuple[str, ModelConfig, MeshPlan]:
    if isinstance(model, ModelConfig):
        cfg, mid = model, model.name
    else:
        mid = str(model)
        if mid not in list_model_ids():
            raise ModelCheckError(
                f"unknown model `{mid}` — known: {list(list_model_ids())}")
        cfg = load_config(mid)
    support = FAMILY_SUPPORT.get(cfg.family)
    if not support:
        why = FAMILY_BLOCKERS.get(
            cfg.family, f"family `{cfg.family}` is not registered")
        raise ModelCheckError(
            f"model `{mid}` is in family `{cfg.family}`, which modelcheck "
            f"cannot decompose yet ({why}) — supported families: "
            f"{sorted(k for k, v in FAMILY_SUPPORT.items() if v)}; "
            f"checkable models: {list(supported_models())}")
    if isinstance(plan, str):
        plan = parse_plan(plan)
    return mid, cfg, plan


def decompose(model: Union[str, ModelConfig], plan: Union[str, MeshPlan],
              *, bug: Optional[str] = None,
              bug_layer: Optional[int] = None,
              device=None) -> Decomposition:
    """Slice ``model`` under ``plan`` into per-block obligations, their
    constants on ``device`` (``cuda`` unless ``"cpu"`` is asked for).

    ``bug="wrong_spec"`` shards one layer's MLP down-projection over the
    wrong mesh axis (default ``bug_layer``: the middle layer).
    """
    mid, cfg, plan = _resolve(model, plan)
    device = str(resolve_device(device))
    if bug is not None:
        if bug not in BUGS:
            raise ModelCheckError(f"unknown bug `{bug}` — known: {BUGS}")
        if bug_layer is None:
            bug_layer = cfg.n_layers // 2
        if not 0 <= bug_layer < cfg.n_layers:
            raise ModelCheckError(
                f"bug_layer {bug_layer} out of range for {cfg.n_layers} "
                f"layers")
    elif bug_layer is not None:
        raise ModelCheckError("bug_layer without bug")

    moe = cfg.family == "moe"
    obset = ObligationSet()
    try:
        obset.add("embed", embed_obligation(cfg, plan))
        for i in range(cfg.n_layers):
            role = cfg.pattern[i % len(cfg.pattern)]
            if role not in ("global", "local"):
                raise ModelCheckError(
                    f"model `{mid}`: layer role `{role}` is not "
                    f"decomposable yet")
            layer_bug = bug if (bug is not None and i == bug_layer) else None
            obset.add(f"layer{i}",
                      layer_obligation(cfg, plan, role=role, moe=moe,
                                       bug=layer_bug, device=device))
        obset.add("head", head_obligation(cfg, plan))
    except BlockBuildError as e:
        raise ModelCheckError(f"model `{mid}` under plan "
                              f"`{plan.name}`: {e}") from e
    return Decomposition(mid, cfg, plan, obset, bug=bug, bug_layer=bug_layer,
                         device=device)
