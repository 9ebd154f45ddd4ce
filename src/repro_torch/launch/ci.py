"""CI driver for the port: the twin of ``scripts/ci.sh``, one target for
each Makefile target the port has.

    PYTHONPATH=src python -m repro_torch.launch.ci <target> [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.ci --list

Each target runs the same commands as ``scripts/ci.sh`` with the port's
entry points, from the repo root, and holds each to the same exit code:
0, or exactly 1 where an injected bug must be caught and localized (a 2
is a harness problem and fails). ``--device`` goes to every command that
takes it (the port runs on ``cuda`` unless ``cpu`` is asked for).
``bench-smoke`` and ``bench-gate`` have no port counterpart yet (the
port's benchmark is still to come): they say so and exit 2. Exit codes:
0 every command as expected, 1 one was not, 2 an unknown or absent
target.
"""
import argparse
import glob
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
VERIFY = ("-m", "repro_torch.launch.verify")
TRACE = os.path.join(tempfile.gettempdir(), "graphguard_torch_trace.json")
GOLDEN_OUT = os.path.join("build", "suite_degree2_torch.json")
TESTS = "tests/test_torch_*.py"


class Step:
    """One command: ``python <argv>`` (a ``*`` pattern expanded to the
    files it matches), the exit code it must give, whether ``--device``
    applies, and a string its output must hold (if any)."""

    def __init__(self, *argv, rc=0, device=True, expect=None):
        self.argv, self.rc, self.device = list(argv), rc, device
        self.expect = expect

    def command(self, device) -> list:
        argv = [path for a in self.argv for path in (
            sorted(glob.glob(os.path.join(ROOT, a))) if "*" in a else [a])]
        if self.device and device is not None:
            argv += ["--device", device]
        return [sys.executable] + argv


def _pytest(*extra):
    return Step("-m", "pytest", "-x", "-q", *extra, TESTS, device=False)


# target -> (what it gates, its steps)
TARGETS = {
    "verify": ("the port's tests", [_pytest()]),
    "quick": ("the port's tests without the slow ones",
              [_pytest("-m", "not slow")]),
    "bug-suite": ("the paper's §6.2 case study: every bug class detected",
                  [Step("-m", "repro_torch.verify_bug_suite")]),
    "suite": ("the clean degree-2 matrix on 4 workers against the golden",
              [Step("-m", "repro_torch.api", "--degrees", "2", "--workers",
                    "4", "--check", "tests/golden/suite_degree2.json")]),
    "golden": (f"regenerate the degree-2 golden into {GOLDEN_OUT}",
               [Step("-m", "repro_torch.api", "--update-golden", GOLDEN_OUT,
                     "--workers", "4")]),
    "modelcheck-smoke": (
        "gpt@dp2xtp2 certifies; wrong_spec is localized (rc 1)",
        [Step(*VERIFY, "--model", "gpt", "--plan", "dp2xtp2"),
         Step(*VERIFY, "--model", "gpt", "--plan", "dp2xtp2",
              "--inject-bug", "wrong_spec", "--bug-layer", "3", rc=1)]),
    "gradcheck-smoke": (
        "dp_accum certifies; accum_no_rescale is localized (rc 1)",
        [Step(*VERIFY, "--train", "dp_accum"),
         Step(*VERIFY, "--train", "dp_accum", "--inject-bug",
              "accum_no_rescale", rc=1)]),
    "servecheck-smoke": (
        "tp_decode certifies; stale_cache_shard is localized (rc 1)",
        [Step(*VERIFY, "--serve", "tp_decode"),
         Step(*VERIFY, "--serve", "tp_decode", "--inject-bug",
              "stale_cache_shard", rc=1)]),
    "chaos-smoke": ("injected crashes, exits, hangs and cache corruption "
                    "contained and attributed",
                    [Step("-m", "repro_torch.launch.chaos_smoke")]),
    "cache-smoke": ("cold commits, warm hits, a torn journal line recovered",
                    [Step("-m", "repro_torch.launch.cache_smoke")]),
    "fn-smoke": ("the bring-your-own-function example, and through --fn",
                 [Step("-m", "repro_torch.verify_your_own_fn"),
                  Step(*VERIFY, "--fn",
                       "repro_torch.verify_your_own_fn:make_task",
                       "--json")]),
    "obs-smoke": ("a traced pooled run the inspector reads to its top lemma",
                  [Step(*VERIFY, "--serve", "tp_decode", "--workers", "2",
                        "--trace", TRACE, "--metrics"),
                   Step("-m", "repro_torch.obs", "report", TRACE,
                        device=False, expect="top lemma: ")]),
    "explain-smoke": ("clean certificates explain and replay, bug frontiers "
                      "name the stuck op",
                      [Step("-m", "repro_torch.launch.explain_smoke")]),
    "docs-check": ("README's port --help block, docstring coverage, the "
                   "docs tests",
                   [Step("-m", "repro_torch.launch.check_cli_docs",
                         device=False),
                    Step("-m", "repro_torch.launch.check_docstrings",
                         device=False),
                    Step("-m", "pytest", "-x", "-q",
                         "tests/test_torch_docs.py", device=False)]),
}
# the benchmark's targets: ROADMAP queue 1 item 10, not ported yet
ABSENT = {"bench-smoke": "the port has no benchmark harness yet",
          "bench-gate": "the port has no benchmark or bench gate yet"}


def run_target(target: str, device=None) -> int:
    """Run every step of ``target``; the exit code of the whole."""
    if target in ABSENT:
        print(f"[ci] {target}: {ABSENT[target]} (ROADMAP queue 1, item "
              f"10)", file=sys.stderr)
        return 2
    if target not in TARGETS:
        print(f"[ci] unknown target: {target} "
              f"({'|'.join(list(TARGETS) + list(ABSENT))})", file=sys.stderr)
        return 2
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for step in TARGETS[target][1]:
        cmd = step.command(device)
        print(f"[ci] {target}: {' '.join(cmd[1:])}", flush=True)
        r = subprocess.run(cmd, cwd=ROOT, env=env, text=True,
                           capture_output=step.expect is not None)
        if step.expect is not None:
            sys.stdout.write(r.stdout)
            sys.stderr.write(r.stderr)
        if r.returncode != step.rc:
            print(f"[ci] {target}: exit {r.returncode}, want {step.rc}",
                  file=sys.stderr)
            return 1
        if step.expect is not None and step.expect not in r.stdout:
            print(f"[ci] {target}: no `{step.expect}` in the output",
                  file=sys.stderr)
            return 1
    print(f"[ci] {target}: ok")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.ci",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("target", nargs="?", default="verify")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="passed to every command that takes it (default: "
                         "cuda, which must exist)")
    ap.add_argument("--list", action="store_true",
                    help="print the targets and exit")
    args = ap.parse_args(argv)
    if args.list:
        for name, (what, _) in TARGETS.items():
            print(f"{name:17s} {what}")
        for name, why in ABSENT.items():
            print(f"{name:17s} (exits 2: {why})")
        return 0
    return run_target(args.target, args.device)


if __name__ == "__main__":
    sys.exit(main())
