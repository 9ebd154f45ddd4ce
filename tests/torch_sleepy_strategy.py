"""A case whose build never returns, for the suite's per-task timeout
test: importing this module registers ``_sleepy`` with the port's
registry, and spawned pool workers import it to learn the case. It
imports neither JAX nor any test module. A test that imports it removes
the entry again afterwards.
"""
import time

from repro_torch.api import register_strategy


@register_strategy("_sleepy", degrees=(2,))
def _sleepy(degree=2, bug=None, device=None):
    """Sleeps past any budget a test gives it."""
    time.sleep(30)               # pragma: no cover — killed by its budget
    raise AssertionError
