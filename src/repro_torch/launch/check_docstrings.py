"""Docstring coverage gate for the port's documented packages: the port's
twin of ``scripts/check_docstrings.py`` (no dependencies).

    PYTHONPATH=src python -m repro_torch.launch.check_docstrings

Every module, public class and public top-level function in
``src/repro_torch/core``, ``src/repro_torch/api`` and
``src/repro_torch/obs`` must carry a docstring. Exit codes: 0 clean, 1
findings (one ``path:line: message`` per line).
"""
import ast
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
PACKAGES = [os.path.join("src", "repro_torch", p)
            for p in ("core", "api", "obs")]


def check_file(path: str) -> list:
    """The findings of one file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    rel = os.path.relpath(path, ROOT)
    findings = []
    if not ast.get_docstring(tree):
        findings.append(f"{rel}:1: missing module docstring")
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            kind = "function"
        elif isinstance(node, ast.ClassDef):
            kind = "class"
        else:
            continue
        if not node.name.startswith("_") and not ast.get_docstring(node):
            findings.append(f"{rel}:{node.lineno}: missing docstring on "
                            f"public {kind} `{node.name}`")
    return findings


def main(argv=None) -> int:
    findings = []
    for pkg in PACKAGES:
        for dirpath, _, files in os.walk(os.path.join(ROOT, pkg)):
            for fname in sorted(files):
                if fname.endswith(".py"):
                    findings.extend(check_file(os.path.join(dirpath, fname)))
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} missing docstring(s)")
        return 1
    print("docstring coverage: repro_torch core + api + obs clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
