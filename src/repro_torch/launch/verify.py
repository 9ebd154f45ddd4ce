"""GraphGuard pre-launch verification CLI for the torch port.

Single-layer strategy cases (the paper-§6 matrix):

    python -m repro_torch.launch.verify --case tp_layer [--bug rope_offset] \
        [--degree 2] [--json] [--list] [--device cuda|cpu] \
        [--timeout S] [--workers N] [--cache [DIR] | --no-cache]

Whole-model verification (the ``repro_torch.modelcheck`` subsystem —
block-by-block decomposition with obligation dedup):

    python -m repro_torch.launch.verify --model gpt --plan dp2xtp2 \
        [--inject-bug wrong_spec [--bug-layer 3]] [--workers 4] [--json]

Training-step verification (the ``repro_torch.gradcheck`` subsystem —
per-parameter gradient obligations, relations transposed from the
forward specs):

    python -m repro_torch.launch.verify --train dp_accum \
        [--inject-bug accum_no_rescale] [--degree 2] [--workers 2] [--json]

Serving-path verification (the ``repro_torch.servecheck`` subsystem —
sharded-KV-cache decode steps deduped by position class, plus the
prefill read proving the chain composes):

    python -m repro_torch.launch.verify --serve tp_decode \
        [--inject-bug stale_cache_shard] [--degree 2] [--workers 2] [--json]

All three exit 0 on a certificate, 1 when an injected bug is caught and
localized to its block, parameter or decode step, and 2 when a caller
mistake or a mis-localized bug is reported.

Bring-your-own-function verification (the generic frontend,
``repro_torch.core.from_fx`` + ``repro_torch.api.verify_functions``):
point ``--fn`` at a ``module:callable`` whose callable returns the task,
a dict with ``fn_seq``/``fn_dist``/``mesh``/``in_specs``, ``avals`` or
``example_args``, and optionally ``name``:

    python -m repro_torch.launch.verify \
        --fn repro_torch.verify_your_own_fn:make_task [--json]

The graphs are traced with real tensors on ``--device`` (default ``cuda``;
without a GPU the run raises rather than falling back to the CPU). Exit
codes: 0 for a certificate, 1 for a refinement failure or any other
non-certificate verdict of a case, 2 for a harness problem on the ``--fn``
path (bad target, capture or engine error). ``--json`` emits the
``Report`` (or the ``ModelReport``/``TrainReport``/``ServeReport``) in the
JAX CLI's envelope (``schema_version``, ``kind``, ``timing``, ``report``,
and ``metrics``/``explanation`` only under ``--metrics``/``--explain``);
``--list`` prints the cases, the ``model@plan``, ``train@strategy`` and
``serve@strategy`` tasks and every bug, each tagged ``[case]``,
``[model]``, ``[train]`` or ``[serve]``.
For matrix runs use the suite runner: ``python -m repro_torch.api``.

The case path runs through the shared runtime (``repro_torch.runtime``):
in this process by default, in one supervised worker process (spawned,
tracing on the same device, killed if it overruns its budget) under
``--timeout`` or ``--workers``; ``--cache`` serves a repeat run from the
certificate cache.  ``--model``, ``--train`` and ``--serve`` fan their
obligations over
``--workers`` spawned workers (default: in this process), each budgeted
``--timeout`` seconds (default 600) from the moment it starts.

Observability:

    python -m repro_torch.launch.verify --case tp_layer --trace trace.json
    python -m repro_torch.obs report trace.json

``--trace PATH`` records every engine/pool/cache span of the run into a
Chrome/Perfetto-loadable ``trace.json`` (plus a grep-friendly
``PATH.jsonl``), merging pool-worker spans onto the same timeline;
``--metrics`` prints the process-local metrics registry to stderr and —
under ``--json`` — adds a ``metrics`` key to the envelope.  ``--explain``
prints the proof provenance (the lemma chain of a certificate, the failure
frontier of a refinement error).  None of them changes certificates.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..api import (build_spec, degree_token, get_strategy, list_bugs,
                   list_strategies, parse_degree, run_spec, task_id)
from ..api.registry import list_model_tasks, list_serve_tasks, \
    list_train_tasks
from ..api.suite import add_cache_flags, cache_from_args
from ..device import resolve_device
from ..dist.strategies import STRATEGY_CASES as CASES  # legacy view re-export

# the --json envelope: {"schema_version", "kind", "timing", "report"}
# (+ opt-in "metrics"/"explanation" keys — only when --metrics/--explain
# are passed, so default envelopes keep their pinned four-key shape)
JSON_SCHEMA_VERSION = 2


def run_case(case: str, bug=None, degree: int = 2, max_nodes=400_000,
             quiet=False, device=None):
    """Verify one registered case on ``device`` (``cuda`` unless ``"cpu"``
    is asked for) and return the live ``Certificate``; a refinement
    failure raises ``RefinementError``. Unless ``quiet``, prints the op
    counts, the R_o certificate and the engine's time and size."""
    dev = resolve_device(device)
    spec = build_spec(case, degree=degree, bug=bug, device=dev)
    cert = run_spec(spec, engine_opts={"max_nodes": max_nodes}, device=dev)
    if not quiet:
        print(f"[verify] {case} degree={degree} bug={bug}: "
              f"G_s ops={cert.stats['gs_ops']} G_d ops={cert.stats['gd_ops']}")
        print("R_o certificate:")
        for k, v in cert.r_o.items():
            print(f"  {k} = {v}")
        print(f"  ({cert.stats['time_s']*1e3:.1f} ms, "
              f"{cert.stats['egraph_nodes']} e-nodes)")
    return cert


def _print_registry():
    """One line per registered task, each tagged by kind — ``[case]``
    single-layer strategies (``--case``), ``[model]`` whole-model tasks
    (``--model``/``--plan``), ``[train]`` training-step tasks
    (``--train``), ``[serve]`` serving-path tasks (``--serve``) — then one
    per bug."""
    from ..gradcheck import get_train_strategy, list_train_bugs
    from ..modelcheck.decompose import BUGS as MODEL_BUGS
    from ..servecheck import get_serve_strategy, list_serve_bugs

    print("registered tasks (kind-tagged; see --case / --model / --train "
          "/ --serve):")
    for name in list_strategies():
        entry = get_strategy(name)
        bugs = ", ".join(entry.bug_names()) or "-"
        degs = "/".join(degree_token(d) for d in entry.degrees)
        print(f"  [case]  {name:16s} degrees={degs:10s} "
              f"expected={entry.expected:12s} bugs: {bugs}")
    for task in list_model_tasks():
        model, _, plan = task.partition("@")
        print(f"  [model] {task:16s} (--model {model} --plan {plan})")
    for task in list_train_tasks():
        entry = get_train_strategy(task.partition("@")[2])
        bugs = ", ".join(entry.bug_names()) or "-"
        degs = "/".join(degree_token(d) for d in entry.degrees)
        print(f"  [train] {task:16s} degrees={degs:10s} "
              f"params={','.join(entry.params):8s} bugs: {bugs}")
    for task in list_serve_tasks():
        entry = get_serve_strategy(task.partition("@")[2])
        bugs = ", ".join(entry.bug_names()) or "-"
        degs = "/".join(degree_token(d) for d in entry.degrees)
        print(f"  [serve] {task:16s} degrees={degs:10s} "
              f"steps={entry.n_steps:<8d} bugs: {bugs}")
    print("registered bugs (bug -> host, detection):")
    for bug, (host, bspec) in sorted(list_bugs().items()):
        print(f"  [case]  {bug:22s} -> {host:12s} ({bspec.expected})")
    for bug in MODEL_BUGS:
        print(f"  [model] {bug:22s} -> --model tasks (refinement_error)")
    for bug, (host, bspec) in sorted(list_train_bugs().items()):
        print(f"  [train] {bug:22s} -> train@{host:12s} ({bspec.expected})")
    for bug, (host, bspec) in sorted(list_serve_bugs().items()):
        print(f"  [serve] {bug:22s} -> serve@{host:12s} ({bspec.expected})")


def _json_envelope(kind: str, report_json: dict, timing: dict,
                   metrics=None, explain: bool = False) -> str:
    env = {
        "schema_version": JSON_SCHEMA_VERSION,
        "kind": kind,
        "timing": timing,
        "report": report_json,
    }
    if metrics is not None:
        env["metrics"] = metrics
    if explain:
        # hoist the proof provenance to the envelope level (None when the
        # engine produced no explanation, e.g. on a harness error)
        env["explanation"] = report_json.pop("explanation", None)
    return json.dumps(env, indent=2, sort_keys=True)


def _metrics_snapshot(args):
    """The registry snapshot for the envelope — None unless --metrics."""
    if not args.metrics:
        return None
    from ..obs.metrics import REGISTRY
    return REGISTRY.snapshot()


def _cli_engine_opts(args):
    """Engine options the CLI flags map onto — None when defaulted."""
    return {"explain": True} if args.explain else None


def _print_narrative(expl) -> None:
    """Render an explanation (any kind) to stdout under --explain."""
    from ..core.explain import render_narrative
    if not expl:
        print("[explain] no explanation available for this run")
        return
    print("[explain] proof provenance:")
    for line in render_narrative(expl):
        print(f"  {line}")


def _print_report(report, explain: bool) -> None:
    """The text rendering of one report (the ``--case`` and ``--fn``
    paths): the certificate, or the localized failure, or the verdict."""
    if report.verdict == "certificate":
        for k, v in (report.r_o or {}).items():
            print(f"  {k} = {v}")
        print(f"REFINEMENT HOLDS — `{report.case}` refines its sequential "
              f"spec (certificate above)")
    elif report.verdict == "refinement_error":
        loc = report.localization
        print(f"REFINEMENT FAILED — `{report.case}` bug localized at G_s "
              f"operator #{loc['op_index']} `{loc['op_name']}` (output "
              f"`{loc['out_name']}`):")
        print(json.dumps(loc, indent=2, sort_keys=True))
    else:
        print(f"VERDICT: {report.verdict} — {report.error}")
        return
    if explain:
        _print_narrative(report.explanation)


def _case_timing(report) -> dict:
    stats = report.stats or {}
    return {
        "wall_s": report.wall_s,
        "infer_s": stats.get("time_s", 0.0),
        "phase_s": dict(stats.get("phase_s") or {}),
    }


def _run_model(args, cache) -> int:
    """The ``--model`` path; returns the exit code."""
    from ..modelcheck import ModelCheckError, check_model
    from ..modelcheck.schedule import DEFAULT_TIMEOUT_S
    try:
        report = check_model(args.model, args.plan, bug=args.inject_bug,
                             bug_layer=args.bug_layer, workers=args.workers,
                             engine_opts=_cli_engine_opts(args),
                             timeout_s=args.timeout or DEFAULT_TIMEOUT_S,
                             cache=cache, device=args.device)
    except (ModelCheckError, ValueError) as e:
        print(f"[modelcheck] {e}", file=sys.stderr)
        return 2
    if args.json:
        print(_json_envelope("model", report.to_json(), report.timing(),
                             metrics=_metrics_snapshot(args),
                             explain=args.explain))
    else:
        print(report.to_markdown())
        if args.explain:
            _print_narrative(report.explanation)
        if report.verdict == "certificate":
            print("WHOLE-MODEL REFINEMENT HOLDS "
                  f"({report.unique_obligations} obligations verified for "
                  f"{report.total_blocks} blocks, "
                  f"dedup {report.dedup_ratio:.1f}x)")
        else:
            print(f"WHOLE-MODEL VERDICT: {report.verdict} — failing "
                  f"blocks {report.failing_blocks}")
    # exit codes: 0 clean certificate; 1 expected failure (an injected bug
    # detected AND localized to its block — report.ok encodes that); 2 a
    # harness problem (clean run not ok, or a bug run failing in the wrong
    # block), so CI gates that assert rc==1 catch mis-localization.
    if args.inject_bug is not None:
        if not report.ok:
            print(f"[modelcheck] injected bug NOT correctly localized "
                  f"(expected block {1 + (report.bug_layer or 0)}, failing "
                  f"blocks {report.failing_blocks})", file=sys.stderr)
            return 2
        return 1
    return 0 if report.ok else 1


def _run_train(args, cache) -> int:
    """The ``--train`` path; returns the exit code."""
    from ..gradcheck import check_train
    from ..gradcheck.schedule import DEFAULT_TIMEOUT_S
    try:
        report = check_train(args.train, degree=args.degree,
                             bug=args.inject_bug, workers=args.workers,
                             engine_opts=_cli_engine_opts(args),
                             timeout_s=args.timeout or DEFAULT_TIMEOUT_S,
                             cache=cache, device=args.device)
    except (KeyError, ValueError) as e:
        print(f"[gradcheck] {e}", file=sys.stderr)
        return 2
    if args.json:
        print(_json_envelope("train", report.to_json(), report.timing(),
                             metrics=_metrics_snapshot(args),
                             explain=args.explain))
    else:
        print(report.to_markdown())
        if args.explain:
            _print_narrative(report.explanation)
        if report.verdict == "certificate":
            print(f"TRAIN-STEP REFINEMENT HOLDS ({len(report.params)} "
                  f"parameter gradients verified, relations transposed "
                  f"from the forward specs)")
        else:
            print(f"TRAIN-STEP VERDICT: {report.verdict} — failing "
                  f"parameters {report.failing_params}")
    # exit codes mirror the model path: 0 clean certificate; 1 expected
    # failure (injected gradient bug detected AND localized to its
    # parameter — report.ok encodes that); 2 a harness problem.
    if args.inject_bug is not None:
        if not report.ok:
            print(f"[gradcheck] injected bug NOT correctly localized "
                  f"(expected parameter {report.bug_param!r}, failing "
                  f"parameters {report.failing_params})", file=sys.stderr)
            return 2
        return 1
    return 0 if report.ok else 1



def _run_serve(args, cache) -> int:
    """The ``--serve`` path; returns the exit code."""
    from ..servecheck import check_serve
    from ..servecheck.schedule import DEFAULT_TIMEOUT_S
    try:
        report = check_serve(args.serve, degree=args.degree,
                             bug=args.inject_bug, workers=args.workers,
                             engine_opts=_cli_engine_opts(args),
                             timeout_s=args.timeout or DEFAULT_TIMEOUT_S,
                             cache=cache, device=args.device)
    except (KeyError, ValueError) as e:
        print(f"[servecheck] {e}", file=sys.stderr)
        return 2
    if args.json:
        print(_json_envelope("serve", report.to_json(), report.timing(),
                             metrics=_metrics_snapshot(args),
                             explain=args.explain))
    else:
        print(report.to_markdown())
        if args.explain:
            _print_narrative(report.explanation)
        if report.verdict == "certificate":
            print(f"SERVING-PATH REFINEMENT HOLDS ({report.total_steps} "
                  f"serving blocks proved by {report.unique_obligations} "
                  f"obligations, dedup {report.dedup_ratio:.1f}x — decode "
                  f"chain refines full-sequence prefill)")
        else:
            print(f"SERVING-PATH VERDICT: {report.verdict} — failing "
                  f"steps {report.failing_steps}")
    # exit codes mirror the model/train paths: 0 clean certificate; 1
    # expected failure (injected serving bug detected AND localized to
    # its decode step — report.ok encodes that); 2 a harness problem.
    if args.inject_bug is not None:
        if not report.ok:
            print(f"[servecheck] injected bug NOT correctly localized "
                  f"(expected step{report.bug_step}, failing steps "
                  f"{report.failing_steps})", file=sys.stderr)
            return 2
        return 1
    return 0 if report.ok else 1

def _load_fn_task(target: str):
    """Resolve a ``--fn module:callable`` target and call it.

    The module part is either an importable dotted name or a path to a
    ``.py`` file; the callable takes no arguments and returns the task
    dict.
    """
    mod_part, sep, attr = target.partition(":")
    if not sep or not mod_part or not attr:
        raise ValueError(f"--fn takes MODULE:CALLABLE, got `{target}`")
    if mod_part.endswith(".py") or "/" in mod_part:
        import importlib.util
        spec = importlib.util.spec_from_file_location("_verify_fn_target",
                                                      mod_part)
        if spec is None or spec.loader is None:
            raise ValueError(f"cannot load module file `{mod_part}`")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        import importlib
        module = importlib.import_module(mod_part)
    fn = getattr(module, attr, None)
    if fn is None or not callable(fn):
        raise ValueError(f"`{mod_part}` has no callable `{attr}`")
    return fn()


_FN_TASK_KEYS = ("fn_seq", "fn_dist", "mesh", "in_specs")


def _fn_task_kwargs(task) -> dict:
    """Check a ``--fn`` task dict and return it as ``verify_functions``
    keywords: the four required keys, exactly one of ``avals`` and
    ``example_args``, and an optional ``name`` and ``strict``."""
    if not isinstance(task, dict):
        raise ValueError(f"--fn callable must return a dict, got "
                         f"{type(task).__name__}")
    allowed = {*_FN_TASK_KEYS, "avals", "example_args", "name", "strict"}
    unknown = sorted(set(task) - allowed)
    if unknown:
        raise ValueError(f"unknown task keys {unknown} "
                         f"(allowed: {sorted(allowed)})")
    missing = [k for k in _FN_TASK_KEYS if k not in task]
    if missing:
        raise ValueError(f"task is missing required keys {missing}")
    if ("avals" in task) == ("example_args" in task):
        raise ValueError("task needs exactly one of `avals` and "
                         "`example_args`")
    return dict(task)


def _run_fn(args) -> int:
    """Run the ``--fn`` path: generic fx capture -> standard Report.

    Exit codes follow the case path: 0 clean certificate, 1 refinement
    failure (the implementation does not refine the sequential function),
    2 a harness problem (bad --fn target, or capture/engine error —
    including ``UnsupportedPrimitive`` for code the term language cannot
    model).
    """
    from ..api import verify_functions
    try:
        task = _load_fn_task(args.fn)
        kw = _fn_task_kwargs(task)
    except (ValueError, TypeError, KeyError, ImportError, OSError,
            AttributeError) as e:
        print(f"[fn] {e}", file=sys.stderr)
        return 2
    engine_opts = {"max_nodes": 400_000}
    engine_opts.update(_cli_engine_opts(args) or {})
    report = verify_functions(engine_opts=engine_opts, device=args.device,
                              **kw)
    if args.json:
        print(_json_envelope("fn", report.to_json(), _case_timing(report),
                             metrics=_metrics_snapshot(args),
                             explain=args.explain))
    else:
        _print_report(report, args.explain)
    if report.verdict == "certificate":
        return 0
    return 1 if report.verdict == "refinement_error" else 2


def _case_report(args, cache) -> dict:
    """Run the single case through the shared runtime, so ``--timeout``
    and ``--cache`` behave exactly as they do for suite runs: in this
    process unless ``--timeout`` or ``--workers`` asks for a worker."""
    from ..api.suite import (_BUILTIN, _run_task, outcome_report,
                             registering_module)
    from ..runtime import (RuntimeTask, SupervisedPool, execute_inline,
                           strategy_cache_key)
    device = str(resolve_device(args.device))
    eo = _cli_engine_opts(args)
    key = task_id(args.case, args.degree, args.bug)
    cache_key = None if cache is None else strategy_cache_key(
        build_spec(args.case, degree=args.degree, bug=args.bug,
                   device=device), eo)
    pooled = args.timeout is not None or bool(args.workers)
    module = registering_module(args.case) if pooled else _BUILTIN
    rt = RuntimeTask(key=key, fn=_run_task,
                     args=((args.case, args.degree, args.bug), eo, device,
                           module),
                     budget_s=args.timeout or 120.0, cache_key=cache_key)
    if pooled:
        # budget enforcement needs a supervisor outside the task — one
        # supervised worker (one task needs no more), killed if it overruns
        with SupervisedPool(1, device=device) as pool:
            outcome = pool.execute([rt], cache=cache)[key]
    else:
        outcome = execute_inline([rt], cache=cache)[key]
    return outcome_report(args.case, args.degree, args.bug, outcome)


def main(argv=None):
    from ..gradcheck import list_train_bugs, list_train_strategies
    from ..modelcheck.decompose import BUGS as model_bugs
    from ..servecheck import list_serve_bugs, list_serve_strategies
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default=None, choices=list_strategies(),
                    help="single-layer strategy case (default: tp_layer "
                         "unless --model/--train is given)")
    ap.add_argument("--bug", default=None, choices=sorted(list_bugs()),
                    help="inject a bug class (must be hosted by --case)")
    ap.add_argument("--degree", type=parse_degree, default=None,
                    help="int, or per-mesh-axis like `4x2` for 2D cases "
                         "(default: 2 for --case, the strategy's first "
                         "registered degree for --train)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the graphs are traced and replayed "
                         "(default: cuda, which must exist)")
    ap.add_argument("--fn", default=None, metavar="MODULE:CALLABLE",
                    help="verify an arbitrary user function pair via the "
                         "generic fx frontend: CALLABLE() returns the task "
                         "(a dict with fn_seq/fn_dist/mesh/in_specs, avals "
                         "or example_args, and optionally name and strict)")
    ap.add_argument("--model", default=None,
                    help="whole-model verification: a model id like `gpt` "
                         "(see --list)")
    ap.add_argument("--plan", default="dp2xtp2",
                    help="mesh plan for --model, e.g. dp2 / tp2 / dp2xtp2")
    ap.add_argument("--train", default=None,
                    choices=list_train_strategies(),
                    help="training-step verification: a train strategy "
                         "like `dp_accum` (see --list)")
    ap.add_argument("--serve", default=None,
                    choices=list_serve_strategies(),
                    help="serving-path verification: a serve strategy "
                         "like `tp_decode` (see --list)")
    ap.add_argument("--inject-bug", default=None,
                    choices=tuple(model_bugs)
                    + tuple(sorted(list_train_bugs()))
                    + tuple(sorted(list_serve_bugs())),
                    help="inject a whole-model bug into one layer "
                         "(--model), a gradient bug into one parameter "
                         "(--train), or a serving bug into one decode "
                         "step (--serve)")
    ap.add_argument("--bug-layer", type=int, default=None,
                    help="layer index for --model --inject-bug "
                         "(default: middle)")
    ap.add_argument("--workers", type=int, default=None,
                    help="spawned worker processes: the pool size for "
                         "--model/--train/--serve (default: in this "
                         "process), or "
                         "one supervised worker for --case (N >= 1)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-task budget in seconds, enforced by the "
                         "supervised runtime from the moment a task "
                         "starts on its worker (default: unbudgeted for "
                         "--case, 600 s per obligation for "
                         "--model/--train/--serve)")
    add_cache_flags(ap)
    ap.add_argument("--list", action="store_true",
                    help="print registered case/model/train tasks and "
                         "bugs (kind-tagged) and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit the structured report as JSON (with "
                         "schema_version + per-phase timing)")
    ap.add_argument("--explain", action="store_true",
                    help="record proof provenance and emit the lemma-chain "
                         "explanation: the equality chain proving each "
                         "certificate, or the failure frontier around the "
                         "stuck op for refinement errors; adds an "
                         "`explanation` key to the --json envelope")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record engine/pool/cache spans into a Chrome/"
                         "Perfetto trace JSON at PATH (plus PATH.jsonl; "
                         "a .json.gz PATH gzips both); inspect with "
                         "`python -m repro_torch.obs report PATH`")
    ap.add_argument("--metrics", action="store_true",
                    help="print the metrics registry to stderr after the "
                         "run (and add a `metrics` key to the --json "
                         "envelope)")
    args = ap.parse_args(argv)
    if args.list:
        _print_registry()
        return
    prev_explain = os.environ.get("GRAPHGUARD_EXPLAIN")
    if args.explain:
        # ambient default so spawned pool workers (which rebuild engines
        # from registry names) inherit provenance recording
        os.environ["GRAPHGUARD_EXPLAIN"] = "1"
    try:
        if args.trace is None and not args.metrics:
            return _dispatch(ap, args)
        from ..obs import trace as obs_trace
        from ..obs.metrics import REGISTRY
        if args.metrics:
            REGISTRY.reset()             # per-run numbers, not per-process
        tracer = obs_trace.start("main")
        try:
            return _dispatch(ap, args)
        finally:
            # runs on sys.exit too — bug-detection exit codes (1) still
            # get their trace/metrics
            obs_trace.stop()
            _finish_obs(args, tracer)
    finally:
        # in-process callers (tests) must not inherit the ambient flag
        if args.explain:
            if prev_explain is None:
                os.environ.pop("GRAPHGUARD_EXPLAIN", None)
            else:
                os.environ["GRAPHGUARD_EXPLAIN"] = prev_explain


def _finish_obs(args, tracer) -> None:
    """Export the trace and/or render the metrics registry (stderr only —
    stdout stays report/envelope material)."""
    if args.trace is not None:
        tracer.write_chrome(args.trace)
        # a gzipped trace gets a gzipped jsonl sibling
        jsonl = args.trace[:-len(".json.gz")] + ".jsonl.gz" \
            if args.trace.endswith(".json.gz") else args.trace + ".jsonl"
        tracer.write_jsonl(jsonl)
        print(f"[obs] wrote {args.trace} (+ {jsonl}) — inspect "
              f"with `python -m repro_torch.obs report {args.trace}`",
              file=sys.stderr)
    if args.metrics:
        from ..obs.metrics import render
        print(render(), file=sys.stderr)


def _dispatch(ap, args):
    """Route the parsed args to the case/model/train/serve/fn path."""
    from ..gradcheck import list_train_bugs
    from ..modelcheck.decompose import BUGS as model_bugs
    from ..runtime import resolve_cache
    from ..servecheck import list_serve_bugs
    paths = [flag for flag, v in (("--model", args.model),
                                  ("--train", args.train),
                                  ("--serve", args.serve),
                                  ("--fn", args.fn)) if v is not None]
    if len(paths) > 1:
        ap.error("--model, --train, --serve and --fn are separate paths")
    if args.workers is not None and args.workers < 0:
        ap.error("--workers takes N >= 0")
    if args.model is not None:
        if args.case is not None or args.bug is not None:
            ap.error("--model/--plan and --case/--bug are separate paths")
        if args.inject_bug in list_train_bugs():
            ap.error(f"--inject-bug {args.inject_bug} is a gradient bug — "
                     f"it requires --train")
        if args.inject_bug in list_serve_bugs():
            ap.error(f"--inject-bug {args.inject_bug} is a serving bug — "
                     f"it requires --serve")
        rc = _run_model(args, resolve_cache(cache_from_args(args)))
        if rc:
            sys.exit(rc)
        return
    if args.train is not None:
        if args.case is not None or args.bug is not None:
            ap.error("--train and --case/--bug are separate paths")
        if args.inject_bug in model_bugs:
            ap.error(f"--inject-bug {args.inject_bug} is a whole-model "
                     f"bug — it requires --model")
        if args.inject_bug in list_serve_bugs():
            ap.error(f"--inject-bug {args.inject_bug} is a serving bug — "
                     f"it requires --serve")
        if args.bug_layer is not None:
            ap.error("--bug-layer applies to --model (gradient bugs "
                     "localize to a parameter, not a layer)")
        rc = _run_train(args, resolve_cache(cache_from_args(args)))
        if rc:
            sys.exit(rc)
        return
    if args.serve is not None:
        if args.case is not None or args.bug is not None:
            ap.error("--serve and --case/--bug are separate paths")
        if args.inject_bug in model_bugs:
            ap.error(f"--inject-bug {args.inject_bug} is a whole-model "
                     f"bug — it requires --model")
        if args.inject_bug in list_train_bugs():
            ap.error(f"--inject-bug {args.inject_bug} is a gradient bug — "
                     f"it requires --train")
        if args.bug_layer is not None:
            ap.error("--bug-layer applies to --model (serving bugs "
                     "localize to a decode step, not a layer)")
        rc = _run_serve(args, resolve_cache(cache_from_args(args)))
        if rc:
            sys.exit(rc)
        return
    if args.inject_bug is not None or args.bug_layer is not None:
        ap.error("--inject-bug/--bug-layer require --model, --train or "
                 "--serve (the case path takes --bug)")
    if args.fn is not None:
        if args.case is not None or args.bug is not None:
            ap.error("--fn and --case/--bug are separate paths")
        if args.workers is not None or args.timeout is not None \
                or args.cache is not None:
            ap.error("--workers/--timeout/--cache apply to --case")
        rc = _run_fn(args)
        if rc:
            sys.exit(rc)
        return
    if args.workers is not None and args.workers < 1:
        ap.error("--workers takes N >= 1 (omit it to run in-process)")
    if args.case is None:
        args.case = "tp_layer"
    if args.degree is None:
        args.degree = 2
    from ..api import Report
    d = _case_report(args, resolve_cache(cache_from_args(args)))
    report = Report.from_json(d)
    if args.json:
        print(_json_envelope("case", d, _case_timing(report),
                             metrics=_metrics_snapshot(args),
                             explain=args.explain))
    else:
        _print_report(report, args.explain)
    if report.verdict != "certificate":
        sys.exit(1)


if __name__ == "__main__":
    main()
