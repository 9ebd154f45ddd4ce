"""Documentation gates for the port: the twin of ``tests/test_docs.py``
for what concerns ``repro_torch`` — its lemmas against docs/LEMMAS.md,
README.md's port CLI reference against the real CLI, docstring coverage
over ``repro_torch.{core,api,obs}``, and its metrics against
docs/OBSERVABILITY.md or the README."""
import os
import re

import pytest

from repro_torch.core.lemmas import LEMMAS, all_lemmas
from repro_torch.launch import check_cli_docs, check_docstrings
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(*parts):
    with open(os.path.join(ROOT, *parts), encoding="utf-8") as f:
        return f.read()


def _catalog():
    return set(re.findall(r"^### `([a-z0-9_]+)`", _read("docs", "LEMMAS.md"),
                          flags=re.MULTILINE))


def _port_reference():
    """README.md's "Port CLI reference", up to the next top-level
    section."""
    doc = _read("README.md")
    start = doc.index("### Port CLI reference")
    return doc[start:doc.index("\n## ", start)]


def test_every_port_lemma_is_catalogued():
    missing = {lemma.name for lemma in LEMMAS} - _catalog()
    assert not missing, f"port lemmas without a docs/LEMMAS.md entry: {missing}"


def test_no_catalog_entry_the_port_lacks():
    stale = _catalog() - {lemma.name for lemma in all_lemmas()}
    assert not stale, f"docs/LEMMAS.md entries the port lacks: {stale}"


def test_lemma_sources_match_the_catalog():
    doc = _read("docs", "LEMMAS.md")
    for lemma in LEMMAS:
        heading = re.search(rf"^### `{lemma.name}`([^\n]*)", doc,
                            flags=re.M).group(1)
        assert "ops:" in heading and f"source: {lemma.source}" in heading, \
            lemma.name


def test_cli_help_block_in_sync(capsys):
    assert check_cli_docs.main([]) == 0, capsys.readouterr().out


@pytest.mark.parametrize("needle", [
    "--case", "--bug", "--degree", "--fn", "--model", "--plan", "--train",
    "--serve", "--inject-bug", "--bug-layer", "--device", "--workers",
    "--timeout", "--cache", "--no-cache", "--list", "--json", "--explain",
    "--trace", "--metrics", "GRAPHGUARD_TORCH_CACHE_DIR", "GRAPHGUARD_CHAOS",
    '"schema_version": 2', "top lemma: "])
def test_port_reference_names_every_path_and_flag(needle):
    assert needle in _port_reference()


def test_port_reference_states_every_exit_code():
    ref = _port_reference()
    assert re.search(r"Exit codes: 0 a certificate; 1 .*; 2 ", ref,
                     flags=re.DOTALL)
    for path in ("--model", "--train", "--serve", "--case", "--fn"):
        assert path in ref.split("Exit codes:")[1], path


def test_docstring_coverage_gate(capsys):
    assert check_docstrings.main() == 0, capsys.readouterr().out


def _source_metric_names():
    names = set()
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "src",
                                                      "repro_torch")):
        for fn in files:
            if fn.endswith(".py"):
                names |= set(re.findall(
                    r'REGISTRY\.(?:counter|histogram)\(\s*"([a-z_.]+)"',
                    _read(dirpath, fn)))
    return names


def test_every_live_metric_is_documented():
    documented = set(re.findall(r"`([a-z_]+\.[a-z_]+)`",
                                _read("docs", "OBSERVABILITY.md")
                                + _port_reference()))
    live = _source_metric_names()
    assert live, "no REGISTRY.counter/histogram call sites in repro_torch"
    missing = live - documented
    assert not missing, f"metrics documented nowhere: {missing}"


def test_port_trace_additions_are_documented():
    ref = _port_reference()
    for name in ("`task`", "`device`", "`cuda_initialized`", "`launches`",
                 "`startup`", "`inputs`"):
        assert name in ref, name
    from repro_torch.kernels import ops
    for counter in ops.launch_counts():
        assert f"`{counter}`" in ref, counter


# ---------------------------------------------------------------------------
# README.md's "Port architecture": every subpackage, live links (the twin
# of test_docs.py's ARCHITECTURE.md gates, which stay the reference's)
# ---------------------------------------------------------------------------

def _port_architecture():
    doc = _read("README.md")
    start = doc.index("### Port architecture")
    return doc[start:doc.index("\n### ", start + 1)]


def _subpackages():
    base = os.path.join(ROOT, "src", "repro_torch")
    return sorted(d for d in os.listdir(base)
                  if os.path.isdir(os.path.join(base, d))
                  and not d.startswith(("_", ".")))


def test_port_architecture_covers_every_subpackage():
    doc = _port_architecture()
    subs = _subpackages()
    assert "core" in subs and "csrc" in subs
    for d in subs:
        assert f"](src/repro_torch/{d}/)" in doc, d


def test_port_architecture_links_resolve():
    targets = set(re.findall(r"\]\(([^)#]+)\)", _port_architecture()))
    assert targets
    for target in targets:
        assert os.path.exists(os.path.join(ROOT, target)), target


def test_key_spans_are_documented_and_emitted():
    """The spans docs/OBSERVABILITY.md names are the ones the port emits:
    each is documented there and named in the port's source."""
    doc = _read("docs", "OBSERVABILITY.md")
    src = ""
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "src",
                                                      "repro_torch")):
        src += "".join(_read(dirpath, fn) for fn in files
                       if fn.endswith(".py"))
    for name in ("capture", "infer", "saturate", "extract", "task",
                 "queue", "run", "saturate.batch", "cache.probe",
                 "task.retry", "task.timeout", "pool.degraded"):
        assert f"`{name}`" in doc, name
        assert f'"{name}"' in src, name
