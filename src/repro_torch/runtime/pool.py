"""Supervised worker pool — the shared fault-tolerant execution layer.

Callers describe work as :class:`RuntimeTask`\\ s (a picklable module-level
``fn`` + args, a stable key, a per-task wall-clock budget, optionally a
content-addressed cache key and an in-process fallback closure) and get
back one :class:`TaskOutcome` per key.  The pool guarantees:

* **Per-task hard deadlines** — each task's budget starts ticking when the
  task *starts on a worker* (tracked by heartbeats), not when it is
  submitted, so one slow task can never starve the budget of the tasks
  queued behind it: the supervisor hands the executor one task per
  worker and keeps the rest queued itself (a task the executor takes
  beyond that waits in its call queue already marked running).  A task
  past its deadline is reported as ``timeout`` with its measured elapsed
  time and heartbeat liveness ("worker alive — task over budget" vs "no
  heartbeat — worker hung"); the wedged worker is killed with its pool
  and the survivors resume on a replacement pool.  A worker's start-up
  is not a task's: a task handed to a worker that has not started it
  within :data:`STARTUP_S` is reported as a worker wedged in start-up.
* **Crash containment with exact blame** — a worker death
  (``BrokenProcessPool``: segfault, hard exit, OOM-kill) re-runs every
  unfinished task, but tasks that were *running* at crash time are
  quarantined onto a fresh single-worker pool one at a time with bounded
  retry + exponential backoff, so a poisonous task is blamed precisely
  (with the worker's exit cause in the error string) and an innocent
  bystander killed alongside it is never charged a retry.
* **Graceful degradation** — if a pool cannot be (re)created at all, the
  remaining tasks run in-process, on the same device, and every affected
  outcome carries a structured ``degraded_reason``.
* **Crash-safe persistence** — when a :class:`~.cache.CertificateCache`
  is attached, deterministic outcomes are committed as they arrive, so an
  interrupted run resumes from its last committed task.

Workers are always started with ``spawn``.  A process that has initialized
CUDA cannot hand it to a forked child ("Cannot re-initialize CUDA in
forked subprocess"), and a fork of a process running torch's threads can
wedge; a spawned worker starts from a fresh interpreter, imports the
task's module, and makes its own CUDA context in the pool initializer.
A worker's start-up is therefore seconds, not milliseconds: the pool
keeps its warmed workers across :meth:`SupervisedPool.execute` calls.

Heartbeats ride a ``multiprocessing.Manager`` dict: the worker shim
records the task start and then beats from a daemon thread, which lets
the supervisor distinguish a *dead* worker (beats stopped) from a *hung*
one (beats continue, task over budget).  Each dispatch carries a ticket
that its beats repeat, so a beat left by an earlier dispatch of the same
key (a worker of a discarded pool) is never taken for this one's.  If the
manager cannot start, supervision degrades to budgets from the
executor's pick-up rather than failing.  A traced worker's events travel
back with the task's result (or its exception), never through the
manager: a task that finished always brings its ``task`` span.

Fault injection for all of the above lives in
:mod:`repro_torch.runtime.chaos`.
"""
from __future__ import annotations

import multiprocessing
import signal
import sys
import threading
import time
import types
from concurrent.futures import FIRST_COMPLETED, BrokenExecutor
from concurrent.futures import ProcessPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY
from . import chaos
from .cache import CertificateCache, cacheable_report

DEFAULT_MAX_RETRIES = 2
DEFAULT_BACKOFF_S = 0.1
DEFAULT_HEARTBEAT_S = 0.25
_POLL_S = 0.05
# a worker handed a task must start it (its start beat) within this, or it
# is wedged in start-up: spawn, imports and, on cuda, a CUDA context take
# seconds (7-9 s on an H100 machine), none of it the task's budget
STARTUP_S = 120.0
# how long a broken pool's workers get to finish exiting before their exit
# codes are read (a worker with a CUDA context closes its pipe to the
# parent before the driver has torn the context down and the exit is
# reaped)
EXIT_SETTLE_S = 5.0
START_METHOD = "spawn"

# set in each worker by the pool initializer: the run's device, and why the
# worker could not reach it (then every task on the worker errors)
_WORKER_DEVICE: Optional[str] = None
_WORKER_INIT_ERROR: Optional[str] = None
_WORKER_STARTUP: Optional[dict] = None


class PoolUnavailable(RuntimeError):
    """The process pool cannot be (re)created — degrade to in-process."""


@dataclass(frozen=True)
class RuntimeTask:
    """One schedulable unit of verification work."""
    key: str                             # stable id (attribution + chaos)
    fn: Callable                         # module-level picklable callable
    args: Tuple = ()                     # picklable arguments
    budget_s: float = 120.0              # per-task wall-clock budget
    cache_key: Optional[str] = None      # content-addressed cache identity
    local_fn: Optional[Callable] = None  # zero-arg in-process fallback
                                         # (may close over unpicklables)

    def run_local(self) -> Any:
        return self.local_fn() if self.local_fn is not None \
            else self.fn(*self.args)


@dataclass
class TaskOutcome:
    """What happened to one task, however it was executed."""
    key: str
    status: str                          # ok | timeout | error
    value: Any = None                    # fn's return (status == ok)
    error: Optional[str] = None          # cause (timeout/error statuses)
    wall_s: float = 0.0                  # on-worker elapsed (budget clock)
    queue_s: float = 0.0                 # waited behind pool siblings
    attempts: int = 1
    executor: str = "pool"               # pool | inline
    degraded_reason: Optional[str] = None
    cache: Optional[str] = None          # hit | miss | None (no cache)

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def timing_info(self) -> dict:
        """Queue wait vs on-worker wall, reported separately — a task
        queued behind a slow sibling (large ``queue_s``) is a scheduling
        fact, a slow task (large ``run_s``) an engine fact.  Timing-class
        data: never part of reports' stable summaries."""
        return {"queue_s": round(self.queue_s, 6),
                "run_s": round(self.wall_s, 6)}

    def runtime_info(self) -> dict:
        """The non-trivial facts, for embedding in a Report (empty dict
        when the task ran the boring happy path)."""
        info: Dict[str, Any] = {}
        if self.cache is not None:
            info["cache"] = self.cache
        if self.attempts > 1:
            info["attempts"] = self.attempts
        if self.degraded_reason is not None:
            info["degraded_reason"] = self.degraded_reason
        # `executor` stays off the report: inline-by-request (workers<=1)
        # is not a runtime event, and inline-by-degradation already
        # carries degraded_reason — recording it would make reports
        # differ across worker counts for no informational gain
        return info


def _warm_worker(device: Optional[str], created_at: float) -> None:
    """Pool initializer: import the verifier and reach the run's device.

    Importing ``repro_torch.api`` populates the strategy registry (the
    cases a spawned worker knows) and pays the torch import up front.  On
    ``cuda`` one tiny op and a synchronize make the worker's CUDA context
    before its first task; on ``cpu`` nothing touches a device.  Then one
    tiny ``make_fx`` trace on the device: ``make_fx``'s first use costs
    seconds (~2 s on a CPU), which would otherwise fall in the worker's
    first task and its budget.  A failure is kept, not raised: the worker
    then answers each of its tasks with an error naming it, rather than
    breaking the pool or tracing on another device.  Where the start-up
    went is kept for the ``task`` span: ``spawn_s`` from the executor's
    creation (``created_at``, the parent's clock) to this call
    (interpreter, the caller's ``__main__`` re-imported, unpickling),
    ``import_s``, ``device_s`` and ``trace_s``.
    """
    global _WORKER_DEVICE, _WORKER_INIT_ERROR, _WORKER_STARTUP
    _WORKER_DEVICE = device
    t0 = time.time()
    t1 = t2 = t0
    try:
        import torch
        from torch.fx.experimental.proxy_tensor import make_fx

        from .. import api  # noqa: F401 — populate the registry
        from ..kernels import ops  # noqa: F401 — launch counters
        t1 = t2 = time.time()
        if device is not None and torch.device(device).type != "cpu":
            # one tiny op, read back: makes the CUDA context and waits
            # for the card (on a device that cannot run it, raises here)
            (torch.zeros(1, device=device) + 1).sum().item()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
        t2 = time.time()
        make_fx(lambda a: (a @ a).tanh().sum(0))(
            torch.ones(4, 4, device=device))
    except Exception as e:  # noqa: BLE001 — reported per task by the shim
        _WORKER_INIT_ERROR = (f"worker cannot reach {device}: "
                              f"{type(e).__name__}: {e}")
    _WORKER_STARTUP = {"spawn_s": round(t0 - created_at, 6),
                       "import_s": round(t1 - t0, 6),
                       "device_s": round(t2 - t1, 6),
                       "trace_s": round(time.time() - t2, 6)}


def terminate_pool(pool: ProcessPoolExecutor) -> None:
    """Release a pool without blocking on wedged workers.

    ``shutdown(wait=True)`` would join a worker stuck in a hung task, so
    drop the executor handle and terminate the processes — idle workers
    die instantly, wedged ones get SIGTERM instead of leaking until their
    task (never) finishes.
    """
    procs = list(getattr(pool, "_processes", {}).values())
    pool.shutdown(wait=False, cancel_futures=True)
    for p in procs:
        if p.is_alive():
            p.terminate()


def _describe_exit(code: Optional[int]) -> str:
    if code is None:
        return "still exiting"
    if code < 0:
        try:
            return f"killed by {signal.Signals(-code).name}"
        except ValueError:
            return f"killed by signal {-code}"
    return f"exit code {code}"


class _TaskRaised(Exception):
    """A task's own exception, with the worker's trace batch beside it
    (``args``: the exception, the events)."""


def _worker_shim(fn: Callable, args: tuple, key: str, ticket: int,
                 attempt: int, hb, heartbeat_s: float,
                 trace: bool = False) -> Tuple[Any, Optional[list]]:
    """Runs in the pool worker: mark worker context for chaos, record the
    start beat (``(ticket, start, beat)``), keep beating from a daemon
    thread, then run the task; returns ``(value, events)``.

    When the parent is tracing (``trace``) the shim installs a fresh
    worker :class:`~repro_torch.obs.trace.Tracer`, wraps the task in a
    ``task`` span (key / attempt / worker pid / the worker's device, and
    at its end the worker's kernel launch counts and whether it made a
    CUDA context), and returns the event batch with the value (a task's
    own exception comes back as :class:`_TaskRaised`, carrying it) for
    the supervisor to absorb — each worker keeps its own pid so the merged
    trace has one track per worker process.  A worker killed mid-task
    returns nothing; fault visibility comes from the supervisor-side
    events.
    """
    if _WORKER_INIT_ERROR is not None:
        raise RuntimeError(_WORKER_INIT_ERROR)
    chaos.enter_worker()
    tracer = obs_trace.Tracer("worker") if trace else None
    obs_trace.install(tracer)
    start = time.time()
    if hb is not None:
        try:
            hb[key] = (ticket, start, start)
        except Exception:  # noqa: BLE001 — manager gone: beat-less mode
            hb = None
    stop = threading.Event()
    if hb is not None:
        def _beat(hb=hb):
            while not stop.wait(heartbeat_s):
                try:
                    hb[key] = (ticket, start, time.time())
                except Exception:  # noqa: BLE001 — manager gone mid-task
                    return
        threading.Thread(target=_beat, daemon=True).start()
    try:
        chaos.maybe_fault(key, attempt)  # may segfault/exit/hang here
        if tracer is None:
            return fn(*args), None
        try:
            with tracer.span("task", cat="pool", key=key, attempt=attempt,
                             worker_pid=tracer.pid,
                             device=_WORKER_DEVICE) as sp:
                value = fn(*args)
                sp.attrs.update(_worker_device_facts())
        except Exception as e:  # noqa: BLE001 — re-raised by the parent
            raise _TaskRaised(e, tracer.events) from None
        return value, tracer.events
    finally:
        stop.set()
        if tracer is not None:
            obs_trace.install(None)


def _receive(fut) -> Any:
    """A finished task's value from its future; the worker's trace batch
    that travels with it (or with the task's own exception, re-raised
    here) goes into the parent's tracer."""
    try:
        value, events = fut.result()
    except _TaskRaised as r:
        exc, events = r.args
        _absorb(events)
        raise exc from None
    _absorb(events)
    return value


def _absorb(events: Optional[list]) -> None:
    tracer = obs_trace.current()
    if tracer is not None and events:
        tracer.absorb(list(events))


def _worker_device_facts() -> dict:
    """What this worker did with the card so far: its kernel launch counts
    (``repro_torch.kernels.ops``, cumulative over the worker's life — the
    parent's counters cannot see them), whether it made a CUDA context,
    and where its start-up went."""
    facts: Dict[str, Any] = {}
    if _WORKER_STARTUP is not None:
        facts["startup"] = _WORKER_STARTUP
    if "torch" in sys.modules:
        facts["cuda_initialized"] = sys.modules["torch"].cuda.is_initialized()
    ops = sys.modules.get("repro_torch.kernels.ops")
    if ops is not None:
        facts["launches"] = ops.launch_counts()
    return facts


def execute_inline(tasks: Sequence[RuntimeTask],
                   cache: Optional[CertificateCache] = None,
                   cacheable: Callable[[Any], bool] = cacheable_report,
                   degraded_reason: Optional[str] = None
                   ) -> Dict[str, TaskOutcome]:
    """Sequential in-process execution (``workers <= 1`` and the
    degradation path).  Budgets are not enforceable — an in-process run
    cannot interrupt itself — but results still commit to the cache one
    by one, so an interrupted run resumes from its last committed task.
    Worker-side chaos never fires here (a segfault would take down the
    caller — the exact failure the runtime exists to contain)."""
    outcomes: Dict[str, TaskOutcome] = {}
    for task in tasks:
        outcomes[task.key] = _run_one_inline(task, cache, cacheable,
                                             degraded_reason)
    return outcomes


def _run_one_inline(task: RuntimeTask, cache, cacheable,
                    degraded_reason: Optional[str]) -> TaskOutcome:
    hit = _cache_lookup(task, cache)
    if hit is not None:
        return hit
    t0 = time.perf_counter()
    REGISTRY.counter("pool.tasks").inc()
    try:
        with obs_trace.span("task", cat="pool", key=task.key, inline=True):
            value = task.run_local()
    except Exception as e:  # noqa: BLE001 — one bad task must not sink the run
        return TaskOutcome(
            task.key, "error", executor="inline",
            error=f"task raised in-process: {type(e).__name__}: {e}",
            wall_s=time.perf_counter() - t0,
            degraded_reason=degraded_reason)
    wall_s = time.perf_counter() - t0
    REGISTRY.histogram("pool.run_s").observe(wall_s)
    out = TaskOutcome(task.key, "ok", value=value, executor="inline",
                      wall_s=wall_s, degraded_reason=degraded_reason,
                      cache=_commit(task, value, cache, cacheable))
    return out


def _cache_lookup(task: RuntimeTask, cache) -> Optional[TaskOutcome]:
    if cache is None or task.cache_key is None:
        return None
    value = cache.get(task.cache_key)
    if value is None:
        return None
    return TaskOutcome(task.key, "ok", value=value, attempts=0,
                       executor="cache", cache="hit")


def _commit(task: RuntimeTask, value: Any, cache, cacheable
            ) -> Optional[str]:
    if cache is None or task.cache_key is None:
        return None
    if cacheable(value):
        cache.put(task.cache_key, value)
    return "miss"


def _start_manager(ctx):
    """Start the heartbeat ``Manager`` without the caller's ``__main__``.

    A spawned child runs the parent's main module before anything else
    (as ``__mp_main__``); for a script that imports torch at its top that
    is a torch import — seconds — in a process that only serves a dict
    over a socket.  The main module is hidden for the start alone (the
    child reads it from the preparation data that ``start`` sends), and
    workers, which may need it for their task functions, still get it.
    """
    main = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        return ctx.Manager()
    finally:
        sys.modules["__main__"] = main


class SupervisedPool:
    """Fault-tolerant process-pool executor for :class:`RuntimeTask`\\ s.

    Persistent: the warmed workers (and the heartbeat manager) survive
    across :meth:`execute` calls until :meth:`shutdown`, so repeated
    sweeps run at steady-state speed.  Usable as a context manager.
    """

    def __init__(self, workers: int, device: Optional[str] = None,
                 max_retries: int = DEFAULT_MAX_RETRIES,
                 backoff_s: float = DEFAULT_BACKOFF_S,
                 heartbeat_s: float = DEFAULT_HEARTBEAT_S,
                 warm: bool = True):
        """``device`` is the run's device (``"cuda"``/``"cpu"``, resolved by
        the caller) that each worker reaches in its initializer;
        ``warm=False`` starts bare workers (pure-Python tasks)."""
        if workers < 1:
            raise ValueError("SupervisedPool needs workers >= 1; use "
                             "execute_inline for in-process runs")
        self.workers = workers
        self.device = None if device is None else str(device)
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.heartbeat_s = heartbeat_s
        self.startup_s = STARTUP_S
        self._initializer = _warm_worker if warm else None
        self._ctx = multiprocessing.get_context(START_METHOD)
        self._executor: Optional[ProcessPoolExecutor] = None
        self._manager = None
        self._hb = None          # manager dict: key -> (ticket, start, beat)
        self._tickets: Dict[str, int] = {}   # key -> its dispatch's ticket
        self._next_ticket = 0
        self._trace = False              # ship worker events (execute())

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "SupervisedPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def shutdown(self) -> None:
        self._discard_executor()
        if self._manager is not None:
            try:
                self._manager.shutdown()
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
            self._manager = None
            self._hb = None

    def _ensure_heartbeats(self):
        if self._manager is None and self._hb is None:
            try:
                self._manager = _start_manager(self._ctx)
                self._hb = self._manager.dict()
            except Exception:  # noqa: BLE001 — degrade to pick-up-time budgets
                self._manager, self._hb = None, None
        return self._hb

    def _make_executor(self, size: int) -> ProcessPoolExecutor:
        try:
            return ProcessPoolExecutor(
                max_workers=size, mp_context=self._ctx,
                initializer=self._initializer,
                initargs=((self.device, time.time())
                          if self._initializer is _warm_worker else ()))
        except Exception as e:  # noqa: BLE001 — no pool to be had
            raise PoolUnavailable(
                f"cannot create process pool: {type(e).__name__}: {e}"
            ) from e

    def _ensure_executor(self) -> ProcessPoolExecutor:
        if self._executor is None:
            self._executor = self._make_executor(self.workers)
        return self._executor

    def _discard_executor(self) -> None:
        if self._executor is not None:
            terminate_pool(self._executor)
            self._executor = None

    def _exit_cause(self) -> str:
        """Best-effort exit causes of the (broken) pool's dead workers."""
        return (self._exit_cause_of(self._executor)
                if self._executor is not None else None) \
            or "worker process died"

    # -- heartbeat bookkeeping ----------------------------------------------
    def _beat_of(self, key: str) -> Optional[Tuple[float, float]]:
        """``(start, last beat)`` of the key's current dispatch, if its
        worker has started it."""
        if self._hb is None:
            return None
        try:
            beat = self._hb.get(key)
        except Exception:  # noqa: BLE001 — manager died mid-run
            self._hb = None
            return None
        if beat is None or beat[0] != self._tickets.get(key):
            return None
        return beat[1:]

    def _clear_beat(self, key: str) -> None:
        if self._hb is not None:
            try:
                self._hb.pop(key, None)
            except Exception:  # noqa: BLE001
                self._hb = None

    # -- execution ----------------------------------------------------------
    def execute(self, tasks: Sequence[RuntimeTask],
                cache: Optional[CertificateCache] = None,
                cacheable: Callable[[Any], bool] = cacheable_report
                ) -> Dict[str, TaskOutcome]:
        """Run every task; always returns one outcome per key."""
        keys = [t.key for t in tasks]
        if len(set(keys)) != len(keys):
            raise ValueError("duplicate task keys")
        outcomes: Dict[str, TaskOutcome] = {}
        todo: List[RuntimeTask] = []
        for t in tasks:
            hit = _cache_lookup(t, cache)
            if hit is not None:
                outcomes[t.key] = hit
            else:
                todo.append(t)
        if not todo:
            return outcomes
        self._trace = obs_trace.current() is not None
        try:
            self._supervise(todo, outcomes, cache, cacheable)
        except PoolUnavailable as e:
            obs_trace.event("pool.degraded", cat="fault", reason=str(e))
            REGISTRY.counter("pool.degraded").inc()
            remaining = [t for t in todo if t.key not in outcomes]
            outcomes.update(execute_inline(
                remaining, cache, cacheable,
                degraded_reason=f"degraded to in-process: {e}"))
        return outcomes

    def _submit(self, pool: ProcessPoolExecutor, task: RuntimeTask,
                attempt: int):
        """Hand ``task`` to ``pool`` under a fresh ticket."""
        self._clear_beat(task.key)
        self._next_ticket += 1
        self._tickets[task.key] = self._next_ticket
        return pool.submit(_worker_shim, task.fn, task.args, task.key,
                           self._next_ticket, attempt, self._hb,
                           self.heartbeat_s, self._trace)

    def _obs_task_done(self, key: str, submit_t: Dict[str, float],
                       running_t: Optional[Dict[str, float]], status: str,
                       wall_s: float, attempt: int = 1) -> float:
        """Emit the supervisor-side queue/run spans + pool metrics for one
        finished task; returns its queue wait in seconds."""
        end = time.time()
        submit = submit_t.get(key)
        start = self._start_of(key, submit_t, running_t)
        queue_s = max(start - submit, 0.0) \
            if start is not None and submit is not None else 0.0
        tracer = obs_trace.current()
        if tracer is not None and submit is not None:
            if queue_s > 0:
                tracer.complete("queue", submit, submit + queue_s,
                                cat="pool", key=key)
            tracer.complete("run", start if start is not None else submit,
                            end, cat="pool", key=key, status=status,
                            attempt=attempt)
        REGISTRY.counter("pool.tasks").inc()
        REGISTRY.histogram("pool.queue_s").observe(queue_s)
        REGISTRY.histogram("pool.run_s").observe(wall_s)
        return round(queue_s, 6)

    def _supervise(self, tasks: List[RuntimeTask], outcomes, cache,
                   cacheable) -> None:
        self._ensure_heartbeats()
        pending: Dict[str, RuntimeTask] = {t.key: t for t in tasks}
        stalls = 0
        while pending:
            before = len(pending)
            suspects, cause = self._run_shared(pending, outcomes, cache,
                                               cacheable)
            if cause and not suspects and len(pending) == before:
                # the pool broke before any task started (a worker dying
                # in start-up): bounded like a crash, or this loop would
                # rebuild a pool that cannot start forever
                stalls += 1
                if stalls > self.max_retries:
                    for key in list(pending):
                        pending.pop(key)
                        outcomes[key] = TaskOutcome(
                            key, "error", attempts=stalls,
                            error=f"worker pool broke {stalls} times "
                                  f"before the task started (last: "
                                  f"{cause})")
                    return
                continue
            stalls = 0
            for key in suspects:
                self._run_isolated(pending.pop(key), outcomes, cache,
                                   cacheable, first_cause=cause)

    def _run_shared(self, pending: Dict[str, RuntimeTask], outcomes,
                    cache, cacheable) -> Tuple[List[str], str]:
        """Happy path: fan pending tasks out on the shared pool.

        Completed/errored/timed-out tasks are popped from ``pending`` as
        their outcomes land.  The executor holds one task per worker; the
        rest wait here, in ``pending``'s order, and are handed over as
        workers free up.  Returns ``(suspect keys, crash cause)`` on a
        pool break — the tasks that were *running* when the pool died and
        therefore need quarantined re-execution; queued tasks stay in
        ``pending`` for the caller to fan out again.
        """
        pool = self._ensure_executor()
        now = time.time()
        submit_t: Dict[str, float] = {key: now for key in pending}
        running_t: Dict[str, float] = {}
        futs: Dict[Any, str] = {}
        queued = list(pending)
        while futs or queued:
            broken = False
            while queued and len(futs) < self.workers:
                try:
                    fut = self._submit(pool, pending[queued[0]], 1)
                except BrokenExecutor:   # a worker died since the last wait
                    broken = True
                    break
                futs[fut] = queued.pop(0)
            done, _ = wait(set(futs), timeout=0 if broken else _POLL_S,
                           return_when=FIRST_COMPLETED)
            now = time.time()
            for f, key in futs.items():
                if key not in running_t and f.running():
                    running_t[key] = now
            for f in done:
                key = futs.pop(f)
                task = pending.get(key)
                if task is None:
                    continue
                try:
                    value = _receive(f)
                except BrokenExecutor:
                    broken = True
                    continue
                except Exception as e:  # noqa: BLE001 — task-level failure
                    pending.pop(key)
                    wall_s = self._elapsed(key, submit_t, running_t)
                    outcomes[key] = TaskOutcome(
                        key, "error",
                        error=f"worker failed: {type(e).__name__}: {e}",
                        wall_s=wall_s,
                        queue_s=self._obs_task_done(key, submit_t,
                                                    running_t, "error",
                                                    wall_s))
                    continue
                pending.pop(key)
                wall_s = self._elapsed(key, submit_t, running_t)
                outcomes[key] = TaskOutcome(
                    key, "ok", value=value, wall_s=wall_s,
                    queue_s=self._obs_task_done(key, submit_t, running_t,
                                                "ok", wall_s),
                    cache=_commit(task, value, cache, cacheable))
            if broken:
                cause = self._exit_cause()
                self._discard_executor()
                suspects = [k for k in pending if k not in queued
                            and (self._beat_of(k) is not None
                                 or self._hb is None)]
                obs_trace.event("pool.broken", cat="fault", cause=cause,
                                suspects=sorted(suspects))
                REGISTRY.counter("pool.broken").inc()
                return suspects, cause
            expired = [k for k in list(futs.values())
                       if k in pending
                       and self._over_budget(pending[k], submit_t,
                                             running_t)]
            if expired:
                for key in expired:
                    task = pending.pop(key)
                    outcomes[key] = self._timeout_outcome(task, submit_t,
                                                          running_t)
                # the wedged worker dies with its pool; survivors resume
                # on a fresh one
                self._discard_executor()
                for f in futs:
                    f.cancel()
                if pending:
                    return self._run_shared(pending, outcomes, cache,
                                            cacheable)
                return [], ""
        return [], ""

    def _run_isolated(self, task: RuntimeTask, outcomes, cache, cacheable,
                      first_cause: str) -> None:
        """Quarantine: re-run one crash suspect alone on a fresh
        single-worker pool with bounded retry + exponential backoff, so a
        repeat crash blames exactly this task."""
        cause = first_cause
        attempts = 0
        while attempts <= self.max_retries:
            attempts += 1
            if attempts > 1:
                obs_trace.event("task.retry", cat="fault", key=task.key,
                                attempt=attempts, cause=cause)
                REGISTRY.counter("pool.retries").inc()
                time.sleep(self.backoff_s * 2 ** (attempts - 2))
            pool = self._make_executor(1)
            submit_t = {task.key: time.time()}
            running_t: Dict[str, float] = {}
            fut = self._submit(pool, task, attempts)
            try:
                while True:
                    done, _ = wait({fut}, timeout=_POLL_S)
                    if done:
                        break
                    if task.key not in running_t and fut.running():
                        running_t[task.key] = time.time()
                    if self._over_budget(task, submit_t, running_t):
                        outcomes[task.key] = self._timeout_outcome(
                            task, submit_t, running_t, attempts=attempts)
                        return
                try:
                    value = _receive(fut)
                except BrokenExecutor:
                    cause = self._exit_cause_of(pool) or cause
                    obs_trace.event("worker.crash", cat="fault",
                                    key=task.key, attempt=attempts,
                                    cause=cause)
                    continue             # retry on a replacement worker
                except Exception as e:  # noqa: BLE001
                    wall_s = self._elapsed(task.key, submit_t, running_t)
                    outcomes[task.key] = TaskOutcome(
                        task.key, "error", attempts=attempts,
                        error=f"worker failed: {type(e).__name__}: {e}",
                        wall_s=wall_s,
                        queue_s=self._obs_task_done(task.key, submit_t,
                                                    running_t, "error",
                                                    wall_s, attempts))
                    return
                wall_s = self._elapsed(task.key, submit_t, running_t)
                outcomes[task.key] = TaskOutcome(
                    task.key, "ok", value=value, attempts=attempts,
                    wall_s=wall_s,
                    queue_s=self._obs_task_done(task.key, submit_t,
                                                running_t, "ok", wall_s,
                                                attempts),
                    cache=_commit(task, value, cache, cacheable))
                return
            finally:
                terminate_pool(pool)
        obs_trace.event("task.failed", cat="fault", key=task.key,
                        attempts=attempts, cause=cause)
        outcomes[task.key] = TaskOutcome(
            task.key, "error", attempts=attempts,
            error=f"worker crashed on all {attempts} attempts "
                  f"(last: {cause})",
            wall_s=self._elapsed(task.key, {task.key: time.time()}))

    @staticmethod
    def _exit_cause_of(pool: ProcessPoolExecutor) -> Optional[str]:
        """The exit causes of a broken pool's workers, each given up to
        :data:`EXIT_SETTLE_S` (all together) to finish exiting; None when
        none exited with a cause."""
        procs = list((getattr(pool, "_processes", None) or {}).values())
        deadline = time.time() + EXIT_SETTLE_S
        for p in procs:
            p.join(max(deadline - time.time(), 0.0))
        causes = [_describe_exit(p.exitcode) for p in procs
                  if p.exitcode not in (None, 0)]
        return f"worker {', '.join(sorted(set(causes)))}" if causes \
            else None

    # -- budget helpers -----------------------------------------------------
    def _start_of(self, key: str, submit_t: Dict[str, float],
                  running_t: Optional[Dict[str, float]] = None
                  ) -> Optional[float]:
        beat = self._beat_of(key)
        if beat is not None:
            return beat[0]
        if self._hb is None:             # no heartbeats: pick-up-time budget
            return (running_t or {}).get(key, submit_t.get(key))
        if running_t is not None and key in running_t:
            # picked up by the executor but no start beat yet: the
            # worker's start-up, on its own deadline (``_over_budget``),
            # or a worker wedged in it would hang execute() forever
            return running_t[key]
        return None                      # queued — budget not ticking yet

    def _elapsed(self, key: str, submit_t: Dict[str, float],
                 running_t: Optional[Dict[str, float]] = None) -> float:
        start = self._start_of(key, submit_t, running_t)
        return max(time.time() - start, 0.0) if start is not None else 0.0

    def _starting(self, key: str) -> bool:
        """Handed to a worker that has not started it (heartbeats on)."""
        return self._hb is not None and self._beat_of(key) is None

    def _over_budget(self, task: RuntimeTask, submit_t: Dict[str, float],
                     running_t: Optional[Dict[str, float]] = None) -> bool:
        start = self._start_of(task.key, submit_t, running_t)
        limit = self.startup_s if self._starting(task.key) \
            else task.budget_s
        return start is not None and time.time() - start > limit

    def _timeout_outcome(self, task: RuntimeTask,
                         submit_t: Dict[str, float],
                         running_t: Optional[Dict[str, float]] = None,
                         attempts: int = 1) -> TaskOutcome:
        elapsed = self._elapsed(task.key, submit_t, running_t)
        beat = self._beat_of(task.key)
        if beat is not None:
            age = time.time() - beat[1]
            liveness = (f"worker alive (heartbeat {age:.1f}s ago) — task "
                        f"over budget" if age <= 4 * self.heartbeat_s
                        else f"no heartbeat for {age:.1f}s — worker "
                             f"presumed hung")
        elif self._hb is not None:
            liveness = ("no heartbeat since start — worker wedged "
                        "during startup")
        else:
            liveness = "no heartbeat channel — budget from pick-up"
        obs_trace.event("task.timeout", cat="fault", key=task.key,
                        elapsed=round(elapsed, 3), liveness=liveness)
        REGISTRY.counter("pool.timeouts").inc()
        limit = (f"the worker start-up deadline of {self.startup_s:g}s"
                 if beat is None and self._hb is not None
                 else f"per-task budget of {task.budget_s:g}s")
        return TaskOutcome(
            task.key, "timeout", attempts=attempts,
            error=f"exceeded {limit} (ran {elapsed:.1f}s; {liveness})",
            wall_s=elapsed,
            queue_s=self._obs_task_done(task.key, submit_t, running_t,
                                        "timeout", elapsed, attempts))


def pool_stats(outcomes: Dict[str, TaskOutcome]) -> dict:
    """Aggregate queue-wait vs on-worker wall over a run's outcomes.

    Timing-class data for the report families' ``pool`` field and
    ``SuiteResult.summary()["runtime"]`` — never part of stable
    summaries (queue waits vary with worker count and machine load).
    Cache hits (``attempts == 0``) are excluded: they never occupied a
    worker.
    """
    executed = [o for o in outcomes.values() if o.attempts > 0]
    return {
        "tasks": len(executed),
        "queue_s_sum": round(sum(o.queue_s for o in executed), 6),
        "run_s_sum": round(sum(o.wall_s for o in executed), 6),
        "queue_s_max": round(max((o.queue_s for o in executed),
                                 default=0.0), 6),
        "retries": sum(max(o.attempts - 1, 0) for o in executed),
        "timeouts": sum(1 for o in executed if o.status == "timeout"),
    }


def run_tasks(tasks: Sequence[RuntimeTask], workers: int,
              cache: Optional[CertificateCache] = None,
              cacheable: Callable[[Any], bool] = cacheable_report,
              **pool_kw) -> Dict[str, TaskOutcome]:
    """One-shot convenience: inline for ``workers <= 1``, else a
    :class:`SupervisedPool` torn down afterwards."""
    if workers <= 1:
        return execute_inline(tasks, cache, cacheable)
    with SupervisedPool(workers, **pool_kw) as pool:
        return pool.execute(tasks, cache=cache, cacheable=cacheable)
