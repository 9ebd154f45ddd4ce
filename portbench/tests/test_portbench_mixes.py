"""Each mix is deterministic for a seed, and the seed changes the order
and the tokens, never the work."""
import itertools

import pytest
import torch

from portbench import mixes


def test_lengths_are_log_uniform_quantiles_within_the_bounds():
    spec = mixes.load("prefill-mix")["lengths"]
    sizes = mixes.lengths(spec)
    assert len(sizes) == spec["count"] == 64
    assert spec["min"] <= sizes[0] and sizes[-1] <= spec["max"]
    assert sizes == sorted(sizes)
    # log-uniform: the geometric midpoint sits in the middle of the set
    mid = (spec["min"] * spec["max"]) ** 0.5
    assert sum(s < mid for s in sizes) == spec["count"] // 2


def test_unknown_distribution_raises():
    with pytest.raises(ValueError):
        mixes.lengths({"dist": "zipf", "min": 1, "max": 2, "count": 2})


def test_order_same_seed_same_sequence():
    sizes = mixes.lengths(mixes.load("prefill-mix")["lengths"])
    a = list(itertools.islice(mixes.order(sizes, 2**31 + 7), 300))
    b = list(itertools.islice(mixes.order(sizes, 2**31 + 7), 300))
    c = list(itertools.islice(mixes.order(sizes, 2**31 + 8), 300))
    assert a == b and a != c


def test_every_cycle_is_the_whole_set():
    sizes = mixes.lengths(mixes.load("prefill-mix")["lengths"])
    seq = list(itertools.islice(mixes.order(sizes, 5_000_000_001),
                                3 * len(sizes)))
    for k in range(3):
        assert sorted(seq[k * len(sizes):(k + 1) * len(sizes)]) == sizes


def test_sub_seeds_are_distinct_and_fit_a_generator():
    seeds = {mixes.sub_seed(2**33 + 1, w)
             for w in ("weights", "data", "order", "sample")}
    assert len(seeds) == 4 and all(0 <= s < 2**63 for s in seeds)
    torch.Generator().manual_seed(max(seeds))


def test_train_batches_are_deterministic_and_fresh():
    def draw(seed):
        g = torch.Generator().manual_seed(mixes.sub_seed(seed, "data"))
        return [mixes.train_batch(g, 1, 64, 1000, "cpu") for _ in range(3)]
    a, b = draw(4_100_000_001), draw(4_100_000_001)
    for x, y in zip(a, b):
        assert torch.equal(x["tokens"], y["tokens"])
        assert torch.equal(x["labels"], y["labels"])
    # rows that all differ, step to step and tokens from labels
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])
    assert not torch.equal(a[0]["tokens"], a[0]["labels"])
    assert int(a[0]["tokens"].max()) < 1000


def test_train_mix_matches_the_program_defaults():
    """The program's AdamW defaults, but for a warm-up short enough that
    the checked steps reach the full learning rate."""
    from repro_torch.optim.adamw import AdamWConfig
    from dataclasses import asdict
    mix = mixes.load("train-4k")
    opt, default = dict(mix["optimizer"]), asdict(AdamWConfig())
    assert opt.pop("warmup_steps") < mix["checked_steps"] + 1
    default.pop("warmup_steps")
    assert opt == default
