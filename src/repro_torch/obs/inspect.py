"""Trace inspection: turn a trace artifact into a run diagnosis.

``python -m repro_torch.obs report trace.json`` renders, from the artifact
alone (no live process needed):

* **top lemmas** — per-lemma fire counts and in-lemma milliseconds
  aggregated from ``saturate.batch`` events, ranked by time;
* **slowest obligations** — per-task ``queue`` (waiting behind pool
  siblings) vs ``run`` (on-worker wall) split from the supervisor's
  pool spans, so a task queued behind a slow sibling is distinguishable
  from a slow task;
* **pool timeline** — one line per process (parent + each worker pid)
  with the tasks it executed;
* **savings** — cache probe hit ratio and scheduler dedup events;
* **faults** — every ``cat: "fault"`` event (chaos injections, broken
  pools, retries, timeouts, degraded fallbacks).

Accepts both export formats (Chrome ``trace.json`` and the ``.jsonl``
event log).  The final line is always ``top lemma: <name>`` — the
port's tests and ``chip_smoke.py`` look for it.
"""
from __future__ import annotations

from typing import Dict, List

from .trace import load_events


def lemma_totals(events: List[dict]) -> Dict[str, dict]:
    """Aggregate per-lemma ``fires``/``ms`` over ``saturate.batch`` events."""
    totals: Dict[str, dict] = {}
    for e in events:
        if e.get("name") != "saturate.batch":
            continue
        args = e.get("args") or {}
        for name, n in (args.get("fires") or {}).items():
            totals.setdefault(name, {"fires": 0, "ms": 0.0})["fires"] += n
        for name, ms in (args.get("ms") or {}).items():
            totals.setdefault(name, {"fires": 0, "ms": 0.0})["ms"] += ms
    return totals


def obligation_rows(events: List[dict]) -> List[dict]:
    """Per-task queue/run/total milliseconds from the supervisor spans."""
    rows: Dict[str, dict] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "pool":
            continue
        key = (e.get("args") or {}).get("key")
        if key is None or e["name"] not in ("queue", "run", "task"):
            continue
        row = rows.setdefault(key, {"key": key, "queue_ms": 0.0,
                                    "run_ms": 0.0, "pids": set()})
        dur_ms = e.get("dur", 0.0) / 1e3
        if e["name"] == "queue":
            row["queue_ms"] += dur_ms
        elif e["name"] == "run":
            row["run_ms"] += dur_ms
        else:  # worker-side "task" span: fallback run wall + worker pid
            row.setdefault("task_ms", 0.0)
            row["task_ms"] += dur_ms
            row["pids"].add(e.get("pid"))
    out = []
    for row in rows.values():
        if not row["run_ms"] and row.get("task_ms"):
            row["run_ms"] = row["task_ms"]
        row["total_ms"] = row["queue_ms"] + row["run_ms"]
        out.append(row)
    out.sort(key=lambda r: -r["total_ms"])
    return out


def pool_timeline(events: List[dict]) -> List[str]:
    """One line per process: which tasks ran there, in ts order."""
    by_pid: Dict[int, List[tuple]] = {}
    names: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            names[e["pid"]] = (e.get("args") or {}).get("name", "?")
        if (e.get("ph") == "X" and e.get("cat") == "pool"
                and e.get("name") == "task"):
            key = (e.get("args") or {}).get("key", "?")
            by_pid.setdefault(e["pid"], []).append((e.get("ts", 0.0), key))
    lines = []
    for pid in sorted(by_pid):
        tasks = " -> ".join(k for _, k in sorted(by_pid[pid]))
        lines.append(f"  pid {pid} ({names.get(pid, 'worker')}): {tasks}")
    return lines


def fault_lines(events: List[dict]) -> List[str]:
    """Every fault-category event, ts-ordered, one line each."""
    rows = [e for e in events if e.get("cat") == "fault"]
    rows.sort(key=lambda e: e.get("ts", 0.0))
    out = []
    for e in rows:
        args = ", ".join(f"{k}={v}" for k, v in sorted(
            (e.get("args") or {}).items()) if k != "depth")
        out.append(f"  {e['name']} [{args}]")
    return out


def explanation_stats(events: List[dict]) -> Dict[str, float]:
    """Aggregate proof-provenance work: how many explanations were built
    (``explain`` instant events from the engine), total chain steps and
    outputs covered, and the milliseconds spent in ``explain.build``
    spans.  Empty dict when the run had ``--explain`` off."""
    stats = {"explanations": 0, "outputs": 0, "steps": 0, "build_ms": 0.0}
    seen = False
    for e in events:
        if e.get("name") == "explain" and e.get("ph") == "i":
            args = e.get("args") or {}
            stats["explanations"] += 1
            stats["outputs"] += int(args.get("outputs", 0))
            stats["steps"] += int(args.get("steps", 0))
            seen = True
        elif e.get("name") == "explain.build" and e.get("ph") == "X":
            stats["build_ms"] += e.get("dur", 0.0) / 1e3
            seen = True
    return stats if seen else {}


def to_json_report(events: List[dict], top: int = 10) -> dict:
    """The machine-readable counterpart of :func:`render` — same
    aggregations, stable key order (serialize with ``sort_keys=True``)."""
    lemmas = sorted(lemma_totals(events).items(),
                    key=lambda kv: (-kv[1]["ms"], -kv[1]["fires"], kv[0]))
    obligations = []
    for row in obligation_rows(events)[:top]:
        r = dict(row)
        r["pids"] = sorted(p for p in r.get("pids", ()) if p is not None)
        obligations.append(r)
    probes = [e for e in events if e.get("name") == "cache.probe"]
    hits = sum(1 for e in probes
               if (e.get("args") or {}).get("result") == "hit")
    dedup = [dict(e.get("args") or {}) for e in events
             if e.get("name") == "dedup"]
    faults = [{"name": e["name"],
               "args": {k: v for k, v in sorted(
                   (e.get("args") or {}).items()) if k != "depth"}}
              for e in sorted((e for e in events if e.get("cat") == "fault"),
                              key=lambda e: e.get("ts", 0.0))]
    spans = [e for e in events if e.get("ph") == "X"]
    return {
        "schema_version": 1,
        "events": len(events),
        "spans": len(spans),
        "processes": len({e.get("pid") for e in events}),
        "lemmas": {name: {"fires": t["fires"], "ms": round(t["ms"], 3)}
                   for name, t in lemmas[:top]},
        "obligations": [{"key": r["key"],
                         "queue_ms": round(r["queue_ms"], 3),
                         "run_ms": round(r["run_ms"], 3),
                         "total_ms": round(r["total_ms"], 3),
                         "pids": r["pids"]} for r in obligations],
        "cache": None if not probes else {
            "probes": len(probes), "hits": hits,
            "hit_ratio": round(hits / len(probes), 4)},
        "dedup": dedup,
        "faults": faults,
        "explanations": explanation_stats(events) or None,
        "top_lemma": lemmas[0][0] if lemmas else "-",
    }


def render(events: List[dict], top: int = 10) -> str:
    """The full text report for one trace (see module docstring)."""
    lines: List[str] = []
    spans = [e for e in events if e.get("ph") == "X"]
    lines.append(f"trace: {len(events)} events, {len(spans)} spans, "
                 f"{len({e.get('pid') for e in events})} process(es)")

    lemmas = sorted(lemma_totals(events).items(),
                    key=lambda kv: (-kv[1]["ms"], -kv[1]["fires"], kv[0]))
    if lemmas:
        lines.append(f"\n-- top lemmas (by in-lemma time, top {top}) --")
        for name, t in lemmas[:top]:
            lines.append(f"  {name:<24} {t['ms']:9.2f} ms  "
                         f"{t['fires']:6d} fires")

    obligations = obligation_rows(events)
    if obligations:
        lines.append(f"\n-- slowest obligations (queue vs run, top {top}) --")
        for row in obligations[:top]:
            lines.append(f"  {row['key']:<32} queue {row['queue_ms']:8.1f} ms"
                         f"  run {row['run_ms']:8.1f} ms")
        timeline = pool_timeline(events)
        if timeline:
            lines.append("\n-- pool timeline --")
            lines.extend(timeline)

    probes = [e for e in events if e.get("name") == "cache.probe"]
    if probes:
        hits = sum(1 for e in probes
                   if (e.get("args") or {}).get("result") == "hit")
        lines.append(f"\n-- cache --\n  probes {len(probes)}, hits {hits}, "
                     f"hit ratio {hits / len(probes):.2f}")
    for e in events:
        if e.get("name") == "dedup":
            a = e.get("args") or {}
            lines.append(f"  dedup [{a.get('subsystem', '?')}]: "
                         f"{a.get('total')} blocks -> {a.get('unique')} "
                         f"obligations")

    xstats = explanation_stats(events)
    if xstats:
        lines.append("\n-- explanations --")
        lines.append(f"  {xstats['explanations']} explanation(s) covering "
                     f"{xstats['outputs']} output(s), "
                     f"{xstats['steps']} chain step(s) total, built in "
                     f"{xstats['build_ms']:.2f} ms")

    faults = fault_lines(events)
    if faults:
        lines.append("\n-- faults --")
        lines.extend(faults)

    top_name = lemmas[0][0] if lemmas else "-"
    lines.append(f"\ntop lemma: {top_name}")
    return "\n".join(lines)


def report(path: str, top: int = 10, as_json: bool = False) -> int:
    """Load ``path`` (trace.json or .jsonl, optionally gzipped) and print
    the report — text by default, the stable-key JSON object under
    ``as_json``.

    Returns a process exit code: 0 on a readable trace, 1 on an empty
    one (nothing to diagnose usually means the run never started).
    """
    import json as _json
    events = load_events(path)
    if not events:
        if as_json:
            print(_json.dumps({"error": "no events", "path": path},
                              sort_keys=True))
        else:
            print(f"{path}: no events")
        return 1
    if as_json:
        print(_json.dumps(to_json_report(events, top=top), indent=2,
                          sort_keys=True))
    else:
        print(render(events, top=top))
    return 0
