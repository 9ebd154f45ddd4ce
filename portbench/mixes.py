"""The one traffic generator: reads a mix's parameters from
``traffic/<mix>.json`` and draws its inputs from the seed.

A mix names the driver that runs it (``drivers/<driver>.py``) and holds
the sizes that driver reads: for a training mix the batch and sequence
length and the optimizer's settings; for a prefill mix the prompt lengths,
a fixed set (``lengths``) that every seed sends, each cycle in another
order, so that the seed changes the order and the tokens and never the
work.
"""
from __future__ import annotations

import json
import random
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def lengths(spec: dict) -> list:
    """The fixed set of prompt lengths: ``count`` quantiles, at the
    midpoints of equal steps of probability, of the log-uniform
    distribution over [min, max]; sorted."""
    if spec["dist"] != "log_uniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lo, hi, n = spec["min"], spec["max"], spec["count"]
    return sorted(round(lo * (hi / lo) ** ((i + 0.5) / n)) for i in range(n))


def order(sizes: list, seed: int):
    """Endless: each cycle the sizes in another order, drawn from the
    seed."""
    rng = random.Random(seed)
    while True:
        cycle = list(sizes)
        rng.shuffle(cycle)
        yield from cycle


def sub_seed(seed: int, what: str) -> int:
    """A seed of its own for each stream (weights, data, order, sample)."""
    h = 1469598103934665603
    for ch in f"{seed}:{what}":
        h = ((h ^ ord(ch)) * 1099511628211) % (1 << 64)
    return h % (1 << 63)


def token_ids(gen: torch.Generator, shape, vocab: int, device):
    """Uniform token ids in [0, vocab)."""
    return torch.randint(0, vocab, shape, generator=gen, device=device)


def train_batch(gen: torch.Generator, B: int, S: int, vocab: int, device):
    """A fresh (B, S) batch: uniform token ids, then uniform labels."""
    tokens = token_ids(gen, (B, S), vocab, device)
    labels = token_ids(gen, (B, S), vocab, device)
    return {"tokens": tokens, "labels": labels}
