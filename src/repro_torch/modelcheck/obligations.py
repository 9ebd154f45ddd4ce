"""Per-block verification obligations and their structural dedup key.

An :class:`Obligation` is one block-sized verification task: a sequential
fragment, its per-rank SPMD implementation, the mesh, and the input/output
``PartitionSpec``s the decomposer derived from the plan.  It is the
modelcheck analogue of :class:`repro_torch.api.StrategySpec` — and
converts into one (``to_strategy_spec``) so the existing engine plumbing
runs it unchanged.

``canonical_key`` is the dedup identity: structure + shapes + dtypes +
specs + mesh — deliberately *not* the layer index — so the twelve
identical GPT blocks canonicalize to a single obligation and the engine
verifies it once.  A bug injected into one layer changes that layer's
structure fingerprint, splitting it out of the dedup class (which is
exactly how the ``ModelReport`` localizes it).  Avals are
:class:`~repro_torch.api.spec.TensorSpec` ``(shape, torch.dtype)`` pairs;
their tokens are spelled as the JAX package spells its avals, so a key is
the same string in both packages.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..api.spec import StrategySpec
# the token vocabulary is shared with the persistent certificate cache
# (repro_torch.runtime.cache), which content-addresses on these strings
from ..runtime.cache import aval_token as _aval_token
from ..runtime.cache import spec_token as _spec_token


@dataclass(frozen=True)
class Obligation:
    """One block's verification task (hashable by its canonical key)."""
    kind: str                            # embed | block | moe_block | head
    seq_fn: Callable = field(compare=False)
    dist_fn: Callable = field(compare=False)
    mesh_axes: tuple                     # ordered ((axis, size), ...)
    in_specs: tuple                      # PartitionSpec per input
    out_specs: tuple                     # PartitionSpec per output (seams)
    avals: tuple                         # TensorSpec per global input
    input_names: tuple
    structure: tuple                     # extra fingerprint facts, sorted
                                         # (("role", "local"), ("bug", ...))
    description: str = field(default="", compare=False)

    @property
    def key(self) -> str:
        return canonical_key(self)

    def to_strategy_spec(self, *, name: str, bug: Optional[str] = None,
                         expected: str = "certificate") -> StrategySpec:
        """View as a StrategySpec so ``repro_torch.api.runner`` runs it."""
        return StrategySpec(
            self.seq_fn, self.dist_fn, dict(self.mesh_axes),
            tuple(self.in_specs), tuple(self.avals),
            tuple(self.input_names), name=name,
            degree=tuple(s for _, s in self.mesh_axes),
            bug=bug, expected=expected, description=self.description)


def canonical_key(ob: Obligation) -> str:
    """Structural identity of an obligation — everything that determines
    the verification outcome, nothing that doesn't (layer index, block
    position).  Shapes/dtypes/specs/mesh/structure facts are hashed into a
    short stable token prefixed with the kind for readability."""
    parts = [
        "kind=" + ob.kind,
        "mesh=" + ",".join(f"{a}{s}" for a, s in ob.mesh_axes),
        "in=" + ";".join(f"{n}:{_aval_token(a)}:{_spec_token(s)}"
                         for n, a, s in zip(ob.input_names, ob.avals,
                                            ob.in_specs)),
        "out=" + ";".join(_spec_token(s) for s in ob.out_specs),
        "struct=" + ";".join(f"{k}={v}" for k, v in sorted(ob.structure)),
    ]
    digest = hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]
    return f"{ob.kind}-{digest}"


@dataclass
class ObligationSet:
    """The dedup cache: ordered blocks -> unique obligations.

    ``blocks[i]`` is (block name, obligation key); ``unique`` maps key ->
    the representative :class:`Obligation` (the first block that produced
    it).  ``add`` returns the key and whether it was a cache hit.
    """
    blocks: List[Tuple[str, str]] = field(default_factory=list)
    unique: Dict[str, Obligation] = field(default_factory=dict)

    def add(self, block_name: str, ob: Obligation) -> Tuple[str, bool]:
        key = ob.key
        hit = key in self.unique
        if not hit:
            self.unique[key] = ob
        self.blocks.append((block_name, key))
        return key, hit

    @property
    def total_blocks(self) -> int:
        return len(self.blocks)

    @property
    def n_unique(self) -> int:
        return len(self.unique)

    @property
    def dedup_ratio(self) -> float:
        return self.total_blocks / max(self.n_unique, 1)

    def block_indices(self, key: str) -> List[int]:
        return [i for i, (_, k) in enumerate(self.blocks) if k == key]

    def keys_in_order(self) -> List[str]:
        """Unique keys ordered by first appearance in the block sequence."""
        seen, out = set(), []
        for _, k in self.blocks:
            if k not in seen:
                seen.add(k)
                out.append(k)
        return out
