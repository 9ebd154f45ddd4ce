"""repro_torch.servecheck against repro.servecheck: serving-path checks.

Mirrors tests/test_servecheck.py on the port (the registry, the cache
relations, position-class dedup, per-step certificates, bug localization,
the report) on the CPU, and holds it against the JAX package:

* the keys: every canonical obligation key and block list, and the
  persistent cache's ``serve_cache_key``, are the JAX package's strings;
* engine parity: each obligation captured by the JAX package and carried
  across gives, through the port's engine, the JAX engine's verdict,
  ``pretty(R_o)``, localization, lemma fires and explanation; summed over
  a task they are ``BENCH_verify.json``'s (tp_decode@2: 180,604 fires, 8
  explanation steps; batched_decode@2x2: 5,274 and 38);
* capture parity: the port's own ``check_serve`` (its fragments written
  on ``core.spmd``) gives the JAX report, timings and worker counts
  aside: stable summary, R_o, seams and fires, clean at every registered
  degree and for the bugs (``stale_cache_shard`` fails ``['step3']``,
  ``cache_gather_wrong_axis`` ``unexpected_relation`` at ``step1``).

sp_cache, whose read chain is the slow obligation, is held in
tests/test_torch_servecheck_sp.py; the pool, the cache, the replays and
the CLI in tests/test_torch_servecheck_runtime.py.
"""
import functools
import json
import os

import pytest

from repro.core import RefinementError as JRefinementError
from repro.core import capture as jcapture, check_refinement as jcheck
from repro.core import capture_spmd as jcapture_spmd
from repro.core import expand_spmd as jexpand, terms as JT
from repro.runtime.cache import serve_cache_key as jserve_cache_key
from repro.servecheck import check_serve as jcheck_serve
from repro.servecheck import get_serve_strategy as jget_serve_strategy
from repro.servecheck import relations as jrel

from repro_torch.core import RefinementError, check_refinement
from repro_torch.core import terms as PT
from repro_torch.runtime import serve_cache_key
from repro_torch.servecheck import (CACHE_AXES, CACHE_LAYOUTS, ServeReport,
                                    cache_relation, cache_rules, cache_spec,
                                    check_serve, get_serve_strategy,
                                    list_serve_bugs, list_serve_strategies,
                                    register_serve_strategy,
                                    seq_parallel_plan)
from repro_torch.sharding.specs import parse_plan
from torch_parity import carried, outcome, report_fires as fires, \
    stable_report_json as stable_json
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(ROOT, "BENCH_verify.json")))
CPU = {"device": "cpu"}
ALL_SERVE = list_serve_strategies()
ALL_SERVE_BUGS = sorted(list_serve_bugs())
ALL_TASKS = [(s, d, None) for s in ALL_SERVE
             for d in get_serve_strategy(s).degrees] + \
    [(host, None, bug) for bug, (host, _) in sorted(list_serve_bugs().items())]
# sp_cache's tasks run in tests/test_torch_servecheck_sp.py
FAST_TASKS = [t for t in ALL_TASKS if t[0] != "sp_cache"]


def _id(task):
    s, d, b = task
    return f"{s}-{b}" if b else f"{s}-{d}"


@functools.lru_cache(maxsize=None)
def _port(strategy, degree, bug):
    return check_serve(strategy, degree=degree, bug=bug, **CPU)


@functools.lru_cache(maxsize=None)
def _jax(strategy, degree, bug):
    return jcheck_serve(strategy, degree=degree, bug=bug)


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------

def test_serve_registry_covers_strategies_and_bugs():
    assert ALL_SERVE == ("tp_decode", "sp_cache", "batched_decode")
    assert set(ALL_SERVE_BUGS) == {"stale_cache_shard", "pos_off_by_one",
                                   "cache_gather_wrong_axis"}
    for name in ALL_SERVE:                   # the JAX registry, entry for entry
        mine, ref = get_serve_strategy(name), jget_serve_strategy(name)
        assert (mine.n_steps, mine.degrees, dict(mine.bug_steps),
                mine.description) == (ref.n_steps, ref.degrees,
                                      dict(ref.bug_steps), ref.description)
        assert [(b.name, b.expected, b.description) for b in mine.bugs] == \
            [(b.name, b.expected, b.description) for b in ref.bugs]


def test_serve_registry_guards():
    with pytest.raises(KeyError, match="unknown serve strategy"):
        get_serve_strategy("no_such")
    with pytest.raises(ValueError, match="belongs to serve strategy"):
        get_serve_strategy("tp_decode").build(bug="pos_off_by_one")
    with pytest.raises(ValueError, match="not hosted"):
        check_serve("tp_decode", bug="pos_off_by_one", **CPU)
    with pytest.raises(ValueError, match="single-axis"):
        check_serve("tp_decode", degree=(2, 2), **CPU)
    with pytest.raises(ValueError, match="dividing the feature dim"):
        check_serve("tp_decode", degree=3, **CPU)
    with pytest.raises(ValueError, match="dp must be 2"):
        check_serve("batched_decode", degree=(4, 2), **CPU)
    with pytest.raises(ValueError, match="square mesh"):
        check_serve("batched_decode", degree=(2, 4),
                    bug="cache_gather_wrong_axis", **CPU)
    with pytest.raises(ValueError, match="already registered"):
        register_serve_strategy("tp_decode", n_steps=1)(
            lambda degree=2, bug=None: None)


# ---------------------------------------------------------------------------
# cache relations and keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["tp2", "dp2xtp4", "dp2", "sp2", "sp4"])
def test_cache_specs_as_jax(plan):
    """The cache's rules, spec and clean relation under each plan and
    layout are the JAX package's."""
    if plan.startswith("sp"):
        mine, ref = (seq_parallel_plan(int(plan[2:])),
                     jrel.seq_parallel_plan(int(plan[2:])))
    else:
        from repro.sharding.specs import parse_plan as jparse_plan
        mine, ref = parse_plan(plan), jparse_plan(plan)
    assert CACHE_AXES == jrel.CACHE_AXES and \
        CACHE_LAYOUTS == jrel.CACHE_LAYOUTS
    for layout in CACHE_LAYOUTS:
        assert cache_rules(mine, layout).rules == \
            cache_rules(ref, layout).rules == \
            jrel.cache_rules(ref, layout).rules
        assert tuple(cache_spec(mine, layout)) == \
            tuple(jrel.cache_spec(ref, layout))
        got = cache_relation("c", (8, 4), "f", mine, layout)
        want = jrel.cache_relation("c", (8, 4), "f", ref, layout)
        assert PT.pretty(got, 999) == JT.pretty(want, 999)
    with pytest.raises(ValueError, match="cache layout"):
        cache_spec(mine, "rows")
    with pytest.raises(ValueError, match="degree >= 2"):
        seq_parallel_plan(1)


@pytest.mark.parametrize("task", ALL_TASKS, ids=_id)
def test_canonical_keys_and_blocks_as_jax(task):
    """Position-class dedup gives the JAX package's blocks and canonical
    keys (the same strings: a cache entry crosses between them), and each
    key's serve_cache_key is the JAX package's."""
    s, d, b = task
    mine = get_serve_strategy(s).build(degree=d, bug=b)
    ref = jget_serve_strategy(s).build(degree=d, bug=b)
    assert mine.blocks == ref.blocks
    assert list(mine.unique) == list(ref.unique)
    for key in mine.unique:
        assert mine.unique[key].structure == ref.unique[key].structure
        for opts in (None, {"explain": True}, {"max_nodes": 1000}):
            assert serve_cache_key(s, key, opts) == \
                jserve_cache_key(s, key, opts)
    assert (mine.total_blocks, mine.n_unique) == \
        (ref.total_blocks, ref.n_unique)


def test_dedup_counts():
    tp = get_serve_strategy("tp_decode").build(2)
    assert (tp.total_blocks, tp.n_unique) == (9, 4)     # first/mid/last+read
    sp = get_serve_strategy("sp_cache").build(2)
    assert (sp.total_blocks, sp.n_unique) == (9, 4)     # lfirst/lmid/llast
    sp = get_serve_strategy("sp_cache").build(4)
    assert (sp.total_blocks, sp.n_unique) == (9, 3)     # lfirst/llast+read
    bd = get_serve_strategy("batched_decode").build((2, 2))
    assert (bd.total_blocks, bd.n_unique) == (5, 5)     # no dedup
    assert serve_cache_key("tp_decode", "serve_step-abc123") == \
        "serve:tp_decode-abc123:mn400000"


def test_bug_splits_its_position_class():
    """An injected bug changes its step's structure, splitting it out of
    its position class (localization rides on that split)."""
    clean = get_serve_strategy("tp_decode").build(degree=2)
    bugged = get_serve_strategy("tp_decode").build(
        degree=2, bug="stale_cache_shard")
    assert bugged.n_unique == clean.n_unique + 1
    key = dict(bugged.blocks)
    assert key["step3"] != key["step2"] == key["step4"]
    assert bugged.blocks == jget_serve_strategy("tp_decode").build(
        degree=2, bug="stale_cache_shard").blocks


def test_cli_list_serve_rows(capsys):
    from repro_torch.launch.verify import main as verify_main
    verify_main(["--list"])
    out = capsys.readouterr().out
    assert "[serve]" in out
    assert "serve@tp_decode" in out and "serve@batched_decode" in out
    assert "stale_cache_shard" in out and "cache_gather_wrong_axis" in out


# ---------------------------------------------------------------------------
# engine parity: JAX captures through the port's engine
# ---------------------------------------------------------------------------

ENGINE_TASKS = sorted(BENCH["servecheck"])


def _bench_task(key):
    _, strategy, deg = key.split("@")
    degree = tuple(int(d) for d in deg[len("deg"):].split("x"))
    return strategy, degree[0] if len(degree) == 1 else degree


@pytest.mark.parametrize("task", ENGINE_TASKS)
def test_engine_parity_bench_counts(task):
    strategy, degree = _bench_task(task)
    obset = jget_serve_strategy(strategy).build(degree=degree)
    fired = steps = 0
    for key in obset.keys_in_order():
        ob = obset.unique[key]
        gs = jcapture(ob.seq_fn, list(ob.avals), list(ob.input_names))
        gd, r_i = jexpand(jcapture_spmd(
            ob.dist_fn, dict(ob.mesh_axes), list(ob.in_specs),
            list(ob.avals), list(ob.input_names)))
        want = outcome(jcheck, JRefinementError, JT.pretty, gs, gd, r_i)
        got = outcome(check_refinement, RefinementError, PT.pretty,
                      *carried(gs, gd, r_i))
        assert got == want, key
        assert got["verdict"] == "certificate"
        fired += sum(got["fires"].values())
        steps += got["explanation"]["total_steps"]
    bench = BENCH["servecheck"][task]
    assert (fired, steps) == (bench["lemma_fires"], bench["explain_steps"])
    assert (obset.total_blocks, obset.n_unique) == \
        (bench["total_steps"], bench["unique_obligations"])


# ---------------------------------------------------------------------------
# capture parity + clean certification + bug localization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", FAST_TASKS, ids=_id)
def test_serve_task_as_jax(task):
    """The port's capture gives the JAX report: stable summary, R_o,
    seams, fires and the whole JSON apart from timings."""
    report, ref = _port(*task), _jax(*task)
    assert report.stable_summary() == ref.stable_summary()
    assert {k: r.get("r_o") for k, r in report.reports.items()} == \
        {k: r.get("r_o") for k, r in ref.reports.items()}
    assert {k: r.get("seams") for k, r in report.reports.items()} == \
        {k: r.get("seams") for k, r in ref.reports.items()}
    assert fires(report) == fires(ref)
    assert stable_json(report) == stable_json(ref)
    s, d, bug = task
    if bug is None:
        assert report.ok and report.verdict == "certificate"
        assert all(st.verdict == "certificate" and st.relation_ok
                   for st in report.steps)
        bench = BENCH["servecheck"].get(
            f"serve@{s}@deg{report.task_id().split('@deg')[1]}")
        if bench:
            assert sum(sum(f.values()) for f in fires(report).values()) \
                == bench["lemma_fires"]
            assert report.dedup_ratio == bench["dedup_ratio"]


def test_stale_cache_shard_localizes_to_step3():
    report = _port("tp_decode", None, "stale_cache_shard")
    ref = _jax("tp_decode", None, "stale_cache_shard")
    assert report.ok and report.verdict == "refinement_error"
    assert report.failing_steps == ["step3"] and report.bug_step == 3
    # its position-class siblings (steps 1-2, 4-6) stay clean
    by_step = {s.step: s for s in report.steps}
    assert by_step["step3"].localized_op
    assert all(by_step[f"step{t}"].verdict == "certificate"
               for t in (1, 2, 4, 5, 6))
    key = by_step["step3"].obligation
    keys = ("op_index", "op_name", "out_name")
    loc, jloc = (r.reports[key]["localization"] for r in (report, ref))
    assert {k: loc[k] for k in keys} == {k: jloc[k] for k in keys}


def test_cache_gather_wrong_axis_is_an_unexpected_relation_at_step1():
    """The wrong-axis gather still refines, but its R_o is off the spec's
    relation: the seam check flags step 1."""
    report = _port("batched_decode", None, "cache_gather_wrong_axis")
    assert report.ok and report.verdict == "unexpected_relation"
    assert report.failing_steps == ["step1"]
    by_step = {s.step: s for s in report.steps}
    assert by_step["step1"].verdict == "certificate"
    assert not by_step["step1"].relation_ok
    assert [s.step for s in report.steps if not s.relation_ok] == ["step1"]


def test_explanations_match_jax():
    """--explain's roll-up and the stale_cache_shard failure frontier are
    the JAX package's."""
    opts = {"explain": True}
    mine = check_serve("tp_decode", bug="stale_cache_shard",
                       engine_opts=opts, **CPU)
    ref = jcheck_serve("tp_decode", bug="stale_cache_shard",
                       engine_opts=opts)
    assert mine.explanation == ref.explanation
    for key in mine.reports:
        assert mine.reports[key]["explanation"] == \
            ref.reports[key]["explanation"]
    frontier = [r["explanation"] for r in mine.reports.values()
                if r["explanation"]["kind"] == "failure_frontier"]
    assert len(frontier) == 1 and frontier[0]["stuck_op"]["op_name"]


def test_serve_report_json_roundtrip():
    report = _port("tp_decode", 2, None)
    blob = json.dumps(report.to_json(), sort_keys=True)
    back = ServeReport.from_json(json.loads(blob))
    assert back.stable_summary() == report.stable_summary()
    assert back.task_id() == report.task_id() == "serve@tp_decode@deg2"
    assert "explanation" not in report.to_json()
    md = report.to_markdown()
    assert "| step3 | mid | certificate | ok | yes | - |" in md
    assert "9 serving block(s) proved by 4 obligation(s)" in md
    assert _port("batched_decode", None, "cache_gather_wrong_axis") \
        .task_id() == "serve@batched_decode@deg2x2+cache_gather_wrong_axis"
