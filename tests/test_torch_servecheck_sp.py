"""repro_torch.servecheck's sp_cache against repro.servecheck's.

The sequence-parallel cache (row-sharded, owner-only writes folded by the
engine's select fold) has the slow obligation of the serving path: its
read chain, eight ``where(axis_index == owner, upd, cache)`` links per
rank, takes ~25 s in either engine at degree 2. Its checks live in their
own file so that they run beside tests/test_torch_servecheck.py. The
port's capture gives the JAX report at every registered degree, timings
aside, and ``pos_off_by_one`` fails exactly ``['step4']`` at the JAX
package's operator.
"""
import functools

import pytest

from repro.servecheck import check_serve as jcheck_serve

from repro_torch.servecheck import check_serve, get_serve_strategy
from torch_parity import report_fires as fires, \
    stable_report_json as stable_json
from torch_parity import one_thread_module  # noqa: F401 (one thread)

CPU = {"device": "cpu"}


@functools.lru_cache(maxsize=None)
def _port(degree, bug):
    return check_serve("sp_cache", degree=degree, bug=bug, **CPU)


@functools.lru_cache(maxsize=None)
def _jax(degree, bug):
    return jcheck_serve("sp_cache", degree=degree, bug=bug)


@pytest.mark.parametrize("degree", get_serve_strategy("sp_cache").degrees)
def test_sp_cache_certifies_as_jax(degree):
    report, ref = _port(degree, None), _jax(degree, None)
    assert report.ok and report.verdict == "certificate"
    assert all(s.verdict == "certificate" and s.relation_ok
               for s in report.steps)
    assert report.stable_summary() == ref.stable_summary()
    assert fires(report) == fires(ref)
    assert stable_json(report) == stable_json(ref)
    # the owner rank is symmetric: local offset classes only
    assert {s.pos_class for s in report.steps} == \
        ({"lfirst", "lmid", "llast", "full"} if degree == 2
         else {"lfirst", "llast", "full"})


def test_pos_off_by_one_localizes_to_step4():
    report, ref = _port(None, "pos_off_by_one"), _jax(None, "pos_off_by_one")
    assert report.ok and report.verdict == "refinement_error"
    assert report.failing_steps == ["step4"] and report.bug_step == 4
    assert report.stable_summary() == ref.stable_summary()
    assert stable_json(report) == stable_json(ref)
    by_step = {s.step: s for s in report.steps}
    assert by_step["step4"].localized_op
    # step 0 shares step 4's clean position class (lfirst) and stays clean
    assert by_step["step0"].verdict == "certificate"
    assert by_step["step0"].pos_class == by_step["step4"].pos_class
