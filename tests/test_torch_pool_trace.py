"""A finished task's worker span always reaches the merged trace.

A traced pooled run with an injected hang on the last task: every
bystander's ``task`` span is in the trace and the victim's is not, over
several fresh pools whose workers take a while to start (each a pool
started anew, as after a hang). A task handed to the executor beyond its
free workers waits in the executor's call queue already marked running;
charged from there, it timed out behind a sibling and a worker's
start-up, and its span never came back. The worker's events travel with
its result, so a worker that cannot reach the heartbeat manager still
brings its span.
"""
import functools
import time

import pytest

import torch_runtime_tasks as tasks
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import RuntimeTask, SupervisedPool, chaos
from torch_parity import one_thread_module  # noqa: F401 (one thread)

WORKERS = 2
BUDGET_S = 2.0
START_S = 0.8            # each worker's start-up nap (imports, a context)
SIBLING_S = 1.5          # the first two bystanders' run
RUNS = 5


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    for var in (chaos.ENV_SPEC, chaos.ENV_TARGET, chaos.ENV_SEED):
        monkeypatch.delenv(var, raising=False)


def _worker_spans(tracer):
    return {e["args"]["key"] for e in tracer.events
            if e.get("name") == "task" and e.get("ph") == "X"
            and e["pid"] != tracer.pid}


def _traced(pool, ts):
    tracer = obs_trace.start("main")
    try:
        return pool.execute(ts), tracer
    finally:
        obs_trace.stop()


def test_hang_keeps_every_bystanders_span(monkeypatch):
    """The third bystander is queued while the first two start (START_S)
    and run (SIBLING_S): together longer than the budget, each alone
    shorter. Budgets start when a task starts, so it must finish, and
    bring its span."""
    monkeypatch.setenv(chaos.ENV_SPEC, "hang:1")
    monkeypatch.setenv(chaos.ENV_TARGET, "victim")
    ts = [RuntimeTask(f"b{i}", tasks.sleep_report, (f"b{i}", SIBLING_S),
                      budget_s=BUDGET_S) for i in range(2)]
    ts += [RuntimeTask("b2", tasks.report, ("b2",), budget_s=BUDGET_S),
           RuntimeTask("victim", tasks.report, ("victim",),
                       budget_s=BUDGET_S)]
    with SupervisedPool(WORKERS, warm=False) as pool:
        pool._initializer = functools.partial(time.sleep, START_S)
        for _ in range(RUNS):
            out, tracer = _traced(pool, ts)
            assert out["victim"].status == "timeout", out["victim"]
            for t in ts[:-1]:
                assert out[t.key].ok, out[t.key]
            assert _worker_spans(tracer) == {"b0", "b1", "b2"}
            faults = [e["args"]["key"] for e in tracer.events
                      if e.get("name") == "task.timeout"]
            assert faults == ["victim"]


def test_span_travels_with_the_result_without_the_manager():
    """A worker whose heartbeat writes all fail (the manager out of its
    reach) still brings each task's span back with the value."""
    with SupervisedPool(WORKERS, warm=False) as pool:
        pool._hb = tasks.UnreachableBeats()
        out, tracer = _traced(pool, [
            RuntimeTask(k, tasks.report, (k,), budget_s=60.0)
            for k in ("a", "b", "c")])
    assert all(out[k].ok and out[k].value == tasks.report(k) for k in out)
    assert _worker_spans(tracer) == {"a", "b", "c"}


def test_a_raising_task_brings_its_span():
    """A task's own exception comes back with the worker's events: the
    error is the task's, worded as before, and its span is traced."""
    with SupervisedPool(WORKERS, warm=False) as pool:
        out, tracer = _traced(pool, [
            RuntimeTask("bad", tasks.boom, ("bad",), budget_s=60.0),
            RuntimeTask("good", tasks.report, ("good",), budget_s=60.0)])
    assert out["good"].ok
    assert out["bad"].status == "error"
    assert out["bad"].error == ("worker failed: RuntimeError: synthetic "
                                "failure for bad")
    assert _worker_spans(tracer) == {"bad", "good"}


def test_start_up_is_not_the_tasks_budget():
    """A worker whose start-up outlasts a task's budget still runs the
    task: the budget starts at the task's start beat, the start-up has a
    deadline of its own."""
    with SupervisedPool(1, warm=False) as pool:
        pool._initializer = functools.partial(time.sleep, 2 * BUDGET_S)
        out, tracer = _traced(pool, [
            RuntimeTask("slow-start", tasks.report, ("slow-start",),
                        budget_s=BUDGET_S)])
    assert out["slow-start"].ok, out["slow-start"]
    assert _worker_spans(tracer) == {"slow-start"}


def test_a_pool_broken_before_a_hand_over_is_contained():
    """A worker that dies while tasks still wait in the supervisor breaks
    the executor before their hand-over (``submit`` raises): the run goes
    on as after any break, and every task completes."""
    with SupervisedPool(WORKERS, warm=False, backoff_s=0.0) as pool:
        real, killed = pool._submit, []

        def submit(executor, task, attempt):
            if task.key == "b2" and not killed:
                killed.append(next(iter(executor._processes.values())))
                killed[0].kill()
                while not executor._broken:
                    time.sleep(0.01)
            return real(executor, task, attempt)
        pool._submit = submit
        out, tracer = _traced(pool, [
            RuntimeTask(f"b{i}", tasks.sleep_report, (f"b{i}", 0.2),
                        budget_s=60.0) for i in range(4)])
    assert all(out[f"b{i}"].ok for i in range(4)), out
    assert [e["name"] for e in tracer.events
            if e.get("cat") == "fault"] == ["pool.broken"]
