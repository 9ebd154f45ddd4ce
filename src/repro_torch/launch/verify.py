"""GraphGuard pre-launch verification CLI for the torch port.

Single-layer strategy cases (the paper-§6 matrix):

    python -m repro_torch.launch.verify --case tp_layer [--bug rope_offset] \
        [--degree 2] [--json] [--list] [--device cuda|cpu]

The graphs are traced with real tensors on ``--device`` (default ``cuda``;
without a GPU the run raises rather than falling back to the CPU). Exit
codes: 0 for a certificate, 1 for a refinement failure or any other
non-certificate verdict. ``--json`` emits the ``Report`` in the JAX CLI's
envelope (``schema_version``, ``kind``, ``timing``, ``report``).

Not ported yet (ROADMAP queue 1, item 4 and later): ``--timeout``,
``--cache``, ``--workers``, ``--model``, ``--train``, ``--serve``,
``--fn``, ``--explain``, ``--trace`` and ``--metrics``.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..api import (build_spec, degree_token, get_strategy, list_bugs,
                   list_strategies, parse_degree, run_spec, verify)
from ..core import RefinementError

# the --json envelope: {"schema_version", "kind", "timing", "report"}
JSON_SCHEMA_VERSION = 2


def run_case(case: str, bug=None, degree=2, max_nodes=400_000, quiet=False,
             device=None):
    """Verify one case, printing its certificate; raises RefinementError."""
    spec = build_spec(case, degree=degree, bug=bug, device=device)
    cert = run_spec(spec, engine_opts={"max_nodes": max_nodes},
                    device=device)
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
    """One line per registered case, then one per bug."""
    print("registered tasks (kind-tagged; see --case):")
    for name in list_strategies():
        entry = get_strategy(name)
        bugs = ", ".join(entry.bug_names()) or "-"
        degs = "/".join(degree_token(d) for d in entry.degrees)
        print(f"  [case]  {name:16s} degrees={degs:10s} "
              f"expected={entry.expected:12s} bugs: {bugs}")
    print("registered bugs (bug -> host, detection):")
    for bug, (host, bspec) in sorted(list_bugs().items()):
        print(f"  [case]  {bug:22s} -> {host:12s} ({bspec.expected})")


def _case_timing(report) -> dict:
    stats = report.stats or {}
    return {
        "wall_s": report.wall_s,
        "infer_s": stats.get("time_s", 0.0),
        "phase_s": dict(stats.get("phase_s") or {}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="tp_layer", choices=list_strategies(),
                    help="single-layer strategy case (default: tp_layer)")
    ap.add_argument("--bug", default=None, choices=sorted(list_bugs()),
                    help="inject a bug class (must be hosted by --case)")
    ap.add_argument("--degree", type=parse_degree, default=2,
                    help="int, or per-mesh-axis like `4x2` for 2D cases "
                         "(default: 2)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the graphs are traced and replayed "
                         "(default: cuda, which must exist)")
    ap.add_argument("--list", action="store_true",
                    help="print registered cases and bugs and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit the structured report as JSON (with "
                         "schema_version + per-phase timing)")
    args = ap.parse_args(argv)
    if args.list:
        _print_registry()
        return
    if args.json:
        report = verify(args.case, degree=args.degree, bug=args.bug,
                        device=args.device)
        print(json.dumps({"schema_version": JSON_SCHEMA_VERSION,
                          "kind": "case", "timing": _case_timing(report),
                          "report": report.to_json()},
                         indent=2, sort_keys=True))
        if report.verdict != "certificate":
            sys.exit(1)
        return
    try:
        run_case(args.case, args.bug, args.degree, device=args.device)
        print("REFINEMENT HOLDS (certificate above)")
    except RefinementError as e:
        print("REFINEMENT FAILED — bug localized:")
        print(e)
        sys.exit(1)


if __name__ == "__main__":
    main()
