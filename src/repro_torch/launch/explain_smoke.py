"""Proof-provenance gate: the port's twin of ``scripts/explain_smoke.py``.

    PYTHONPATH=src python -m repro_torch.launch.explain_smoke [--device cpu]

Three legs, each traced and replayed on ``--device`` (default ``cuda``,
which must exist):

1. **Clean certificates explain and replay.**  Every single-layer case
   in a representative set, one whole-model run, one train strategy and
   one serve strategy are verified with provenance recording on; every
   resulting certificate explanation must pass the independent replay
   checker (:func:`repro_torch.core.explain.check_explanation`) — the
   lemma chain is re-applied numerically on seeded inputs *outside* the
   e-graph.
2. **Injected bugs produce a failure-frontier narrative.**  Each smoke
   bug (``wrong_spec``, ``accum_no_rescale``, ``stale_cache_shard``)
   must yield a frontier that names the stuck operator, and the
   narrative must mention the lemma frontier (fired-but-did-not-close or
   the explicit no-lemma line).
3. **Explanations are free when off.**  A run with ``explain`` off must
   produce byte-identical certificates (R_o + deterministic stats) to
   the explain-on run, and its report JSON must carry no ``explanation``
   key.

Exit codes: 0 all legs pass, 1 any leg fails. ``run(device)`` returns
the failed checks' names (empty when all pass).
"""
import argparse
import json
import sys

EXPLAIN = {"explain": True}


class _Checks:
    """The checks of one run: each printed as it is made, the failed ones
    kept."""

    def __init__(self):
        self.failures = []

    def __call__(self, ok: bool, what: str) -> None:
        print(f"[explain-smoke] {what}: {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(what)


def _deterministic_stats(stats: dict) -> dict:
    """The stats keys that are byte-stable across runs (no timings)."""
    return {k: stats[k] for k in ("egraph_nodes", "gs_ops", "gd_ops",
                                  "lemma_fires") if k in stats}


def leg_clean_replay(check: _Checks, device: str) -> None:
    """Leg 1: clean certificates explain, and every chain replays."""
    from ..api import verify
    from ..core.explain import check_explanation, explanation_steps
    from ..gradcheck import check_train
    from ..modelcheck import check_model
    from ..servecheck import check_serve

    for case in ("tp_layer", "fsdp_mlp", "sp_moe", "tp_dp_2d"):
        rep = verify(case, engine_opts=EXPLAIN, device=device)
        check(rep.verdict == "certificate" and rep.explanation is not None,
              f"case {case}: certificate with explanation")
        res = check_explanation(rep.explanation, device=device)
        check(res["ok"], f"case {case}: replay "
              f"({res['checked_steps']} step(s)"
              + (f"; {res['failures'][:1]}" if res["failures"] else "")
              + ")")

    def nested(reports):
        for key in sorted(reports):
            expl = reports[key].get("explanation")
            if expl and expl.get("kind") == "certificate":
                yield key, expl

    m = check_model("gpt", "dp2xtp2", workers=0, engine_opts=EXPLAIN,
                    device=device)
    check(m.verdict == "certificate", "model gpt@dp2xtp2: certificate")
    for key, expl in nested(m.reports):
        res = check_explanation(expl, device=device)
        check(res["ok"], f"model obligation {key}: replay "
              f"({explanation_steps(expl)} step(s))")

    t = check_train("dp_accum", engine_opts=EXPLAIN, device=device)
    check(t.verdict == "certificate", "train dp_accum: certificate")
    for key, expl in nested(t.reports):
        check(check_explanation(expl, device=device)["ok"],
              f"train param {key}: replay")

    s = check_serve("tp_decode", engine_opts=EXPLAIN, device=device)
    check(s.verdict == "certificate", "serve tp_decode: certificate")
    for key, expl in nested(s.reports):
        check(check_explanation(expl, device=device)["ok"],
              f"serve obligation {key}: replay")


def leg_bug_frontier(check: _Checks, device: str) -> None:
    """Leg 2: every smoke bug yields a failure-frontier narrative naming
    the stuck op and the lemma frontier."""
    from ..gradcheck import check_train
    from ..modelcheck import check_model
    from ..servecheck import check_serve

    def frontier_of(reports):
        for rep in reports.values():
            expl = rep.get("explanation")
            if expl and expl.get("kind") == "failure_frontier":
                return expl
        return None

    runs = [
        ("model wrong_spec",
         lambda: check_model("gpt", "dp2xtp2", bug="wrong_spec",
                             bug_layer=3, workers=0, engine_opts=EXPLAIN,
                             device=device)),
        ("train accum_no_rescale",
         lambda: check_train("dp_accum", bug="accum_no_rescale",
                             engine_opts=EXPLAIN, device=device)),
        ("serve stale_cache_shard",
         lambda: check_serve("tp_decode", bug="stale_cache_shard",
                             engine_opts=EXPLAIN, device=device)),
    ]
    for name, run in runs:
        rep = run()
        check(rep.ok, f"bug {name}: detected and localized")
        expl = frontier_of(rep.reports)
        check(expl is not None, f"bug {name}: failure frontier present")
        if expl is None:
            continue
        stuck = expl.get("stuck_op") or {}
        check(bool(stuck.get("op_name")),
              f"bug {name}: frontier names stuck op "
              f"`{stuck.get('op_name')}` (#{stuck.get('op_index')})")
        narrative = "\n".join(expl.get("narrative") or ())
        check("stuck at" in narrative and "lemma" in narrative,
              f"bug {name}: narrative mentions stuck op + lemma frontier")


def leg_off_identical(check: _Checks, device: str) -> None:
    """Leg 3: explain-off certificates are byte-identical and carry no
    explanation key."""
    from ..api import verify

    for case in ("tp_layer", "sp_moe"):
        off = verify(case, device=device)
        on = verify(case, engine_opts=EXPLAIN, device=device)
        check("explanation" not in off.to_json(),
              f"case {case}: off-report has no explanation key")
        check(off.r_o == on.r_o
              and _deterministic_stats(off.stats)
              == _deterministic_stats(on.stats),
              f"case {case}: off/on certificates byte-identical")
        check(json.dumps(on.explanation, sort_keys=True)
              == json.dumps(verify(case, engine_opts=EXPLAIN,
                                   device=device).explanation,
                            sort_keys=True),
              f"case {case}: explanation deterministic across runs")


def run(device=None) -> list:
    """All three legs on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for); returns the names of the checks that failed."""
    from ..models.registry import resolve_device
    device = str(resolve_device(device))
    check = _Checks()
    leg_clean_replay(check, device)
    leg_bug_frontier(check, device)
    leg_off_identical(check, device)
    return check.failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the graphs are traced and replayed "
                         "(default: cuda, which must exist)")
    failures = run(ap.parse_args(argv).device)
    if failures:
        print(f"[explain-smoke] FAIL: {len(failures)} check(s) failed",
              file=sys.stderr)
        return 1
    print("[explain-smoke] all legs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
