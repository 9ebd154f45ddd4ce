"""A case registered outside the port, for the suite tests: importing this
module registers ``user_tp_mlp`` (one hosted bug) with the port's
registry. Spawned pool workers import it to learn the case. It imports
neither JAX nor any test module. A test that imports it removes the entry
again afterwards.
"""
import torch

from repro_torch.api import BugSpec, StrategySpec, TensorSpec, \
    register_strategy
from repro_torch.core.spmd import PartitionSpec as P
from repro_torch.core.spmd import psum


def _seq(x, w1, w2):
    return torch.tanh(x @ w1) @ w2


def _dist(x, w1, w2):
    return psum(torch.tanh(x @ w1) @ w2, "tp")


def _dist_avg(x, w1, w2):
    return psum(torch.tanh(x @ w1) @ w2, "tp") / 2


@register_strategy("user_tp_mlp", degrees=(2,),
                   bugs=[BugSpec("user_psum_as_mean")])
def user_tp_mlp(degree=2, bug=None, device=None):
    """A TP MLP registered by a user's own module."""
    avals = [TensorSpec(s, torch.float32) for s in ((4, 8), (8, 8), (8, 8))]
    return StrategySpec(_seq, _dist_avg if bug else _dist, {"tp": degree},
                        (P(), P(None, "tp"), P("tp", None)), avals,
                        ("x", "w1", "w2"))
