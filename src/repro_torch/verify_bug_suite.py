"""The paper's §6.2 case study over every registered bug class (the paper's
six plus the FSDP / pipeline / 2D-mesh families), driven through the
``repro_torch.api`` suite runner.

    PYTHONPATH=src python -m repro_torch.verify_bug_suite [--device cpu]

One task per registered bug, each under its host case at degree 2 (the
host cases' clean runs ride along), run in-process on ``--device``
(``cuda`` unless ``cpu`` is asked for; no CUDA device is an error, not a
fallback). One line per bug; exit 0 only if every task met its
registered expectation.
"""
import argparse
import sys
from typing import Optional

from repro_torch.api import Suite, SuiteResult, list_bugs


def run_bug_suite(device=None) -> SuiteResult:
    """Every registered bug under its host case at degree 2, in-process."""
    bugs = list_bugs()
    suite = Suite(cases=sorted({host for host, _ in bugs.values()}),
                  degrees=(2,), bugs=sorted(bugs))
    return suite.run(workers=0, device=device)


def status(report) -> Optional[str]:
    """One bug task's line (None for a host case's clean run)."""
    if report.bug is None:
        return None
    if report.verdict == "refinement_error":
        what = ("detected: " + report.localization["op_name"]
                + f" at G_s op #{report.localization['op_index']}")
    elif report.verdict == "certificate" and \
            report.expected == "unexpected_relation":
        what = "detected via unexpected R_o: " + \
            str(list(report.r_o.values())[0])
    else:
        what = f"NOT DETECTED (unexpected verdict {report.verdict})"
    return f"bug {report.bug:16s} -> {what}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.verify_bug_suite",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where every task traces (default: cuda, which "
                         "must exist)")
    result = run_bug_suite(ap.parse_args(argv).device)
    for report in result:
        line = status(report)
        if line is not None:
            print(line)
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
