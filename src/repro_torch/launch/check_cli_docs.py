"""Keep README.md's port CLI reference in sync with the port's real CLI:
the port's twin of ``scripts/check_cli_docs.py``.

    PYTHONPATH=src python -m repro_torch.launch.check_cli_docs [--update]

Regenerates ``python -m repro_torch.launch.verify --help`` (COLUMNS
pinned to 80, so argparse's wrapping is deterministic) and compares it
with the block between the ``TORCH-VERIFY-HELP`` markers of README.md's
"Port CLI reference". Exit codes: 0 in sync (or regenerated under
``--update``), 1 stale, 2 markers missing.
"""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DOC = os.path.join(ROOT, "README.md")
BEGIN = "<!-- BEGIN TORCH-VERIFY-HELP -->"
END = "<!-- END TORCH-VERIFY-HELP -->"


def real_help() -> str:
    """The port CLI's ``--help`` at 80 columns."""
    env = dict(os.environ, COLUMNS="80",
               PYTHONPATH=os.path.join(ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.verify", "--help"],
        capture_output=True, text=True, env=env, cwd=ROOT, check=True).stdout
    # argparse names the prog after the module's file; normalize it
    return out.replace("usage: verify.py", "usage: repro_torch.launch.verify")


def render(help_text: str) -> str:
    """The marked block for ``help_text``."""
    return f"{BEGIN}\n```text\n{help_text.rstrip()}\n```\n{END}"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(DOC, encoding="utf-8") as f:
        doc = f.read()
    pattern = re.compile(re.escape(BEGIN) + ".*?" + re.escape(END),
                         flags=re.DOTALL)
    if not pattern.search(doc):
        print(f"error: README.md is missing the {BEGIN} / {END} markers")
        return 2
    fresh = pattern.sub(lambda _: render(real_help()), doc)
    if fresh == doc:
        print("README.md port --help block is in sync")
        return 0
    if "--update" in argv:
        with open(DOC, "w", encoding="utf-8") as f:
            f.write(fresh)
        print("README.md port --help block regenerated")
        return 0
    print("error: README.md port --help block is stale — run "
          "`python -m repro_torch.launch.check_cli_docs --update`")
    return 1


if __name__ == "__main__":
    sys.exit(main())
