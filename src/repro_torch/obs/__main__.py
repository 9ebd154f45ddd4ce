"""CLI for trace inspection: ``python -m repro_torch.obs report trace.json``.

Renders the top-N lemma ranking, the per-obligation queue-vs-run
breakdown, the pool timeline, cache/dedup savings, and fault events from
a ``--trace`` artifact (either the Chrome ``trace.json`` or its
``.jsonl`` sibling).  Exits 0 on a readable trace, 1 on an empty one.
"""
from __future__ import annotations

import argparse
import sys

from .inspect import report


def main(argv=None) -> int:
    """Parse ``report PATH [--top N]`` and print the trace report."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect a trace written by `repro_torch.launch.verify "
                    "--trace PATH`.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="render a trace artifact")
    rep.add_argument("path", help="trace.json (Chrome) or .jsonl event log "
                                  "(either may be gzipped: .gz)")
    rep.add_argument("--top", type=int, default=10,
                     help="rows per ranking section (default 10)")
    rep.add_argument("--json", action="store_true",
                     help="emit the report as a JSON object with stable "
                          "key order instead of text")
    args = ap.parse_args(argv)
    return report(args.path, top=args.top, as_json=args.json)


if __name__ == "__main__":
    sys.exit(main())
