"""Deterministic synthetic data pipeline.

Produces seeded token streams with Zipfian unigram statistics plus short
copy motifs (so a ~100M model shows a real, reproducible loss drop within a
few hundred steps). Shard-aware: each data-parallel host pulls its own slice
by (step, shard) without coordination. The draws are numpy's, so a batch
is the JAX package's batch for the same (seed, step, shard), bit for bit;
its tokens come as int64 torch tensors on ``cuda`` unless ``device="cpu"``
is asked for.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.registry import resolve_device


@dataclass
class SyntheticTextDataset:
    vocab: int
    seq_len: int
    batch: int          # per-host batch
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)

    def batch_at(self, step: int, device=None) -> dict:
        """``{"tokens", "labels"}``: (batch, seq_len) int64 tensors on
        ``device`` (``cuda`` unless ``"cpu"`` is asked for), the labels
        the tokens shifted by one."""
        rng = self._rng(step)
        V = self.vocab
        # Zipf-ish unigram distribution over the first 4k tokens
        support = min(V, 4096)
        ranks = np.arange(1, support + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(support, size=(self.batch, self.seq_len + 1),
                          p=probs).astype(np.int32)
        # motif: periodic copy pattern gives learnable structure
        period = 8
        toks[:, period::period] = \
            toks[:, ::period][:, : toks[:, period::period].shape[1]]
        toks = torch.from_numpy(toks.astype(np.int64)) \
            .to(resolve_device(device))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_specs(cfg, shape, abstract=True):
    """Meta-device batch stand-ins for (cfg, InputShape) — see
    launch.inputs."""
    from ..launch.inputs import input_specs
    return input_specs(cfg, shape)
