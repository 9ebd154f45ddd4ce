"""The port's fault-tolerant runtime (``repro_torch.runtime``) on the CPU:
the certificate cache, the chaos harness and the supervised pool of
spawned workers, held to the behaviours of the JAX package's runtime and,
where the two must agree bit for bit (journal lines, chaos draws), to the
JAX package itself.

Pool tests run pure-Python tasks from ``torch_runtime_tasks`` on bare
workers (``warm=False``). A task that should succeed gets a budget of at
least 60 s; only a victim meets its budget.
"""
import json
import os
import random
import subprocess
import sys

import pytest

import torch_runtime_tasks as tasks
from repro.runtime import chaos as jax_chaos
from repro.runtime.cache import _line_for as jax_line_for
from repro_torch.api import build_spec
from repro_torch.runtime import (DEFAULT_CACHE_DIR, CertificateCache,
                                 PoolUnavailable, RuntimeTask, SupervisedPool,
                                 cacheable_report, chaos, execute_inline,
                                 resolve_cache, run_tasks, strategy_cache_key)
from repro_torch.runtime import pool as pool_mod
from repro_torch.runtime.cache import ENV_CACHE_DIR, _line_for, _parse_line

BARE = {"warm": False}


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    """Chaos/cache env must never leak between tests (or in from the
    invoking shell)."""
    for var in (chaos.ENV_SPEC, chaos.ENV_TARGET, chaos.ENV_SEED,
                ENV_CACHE_DIR, "GRAPHGUARD_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)


def _task(key, fn=tasks.report, args=None, **kw):
    kw.setdefault("budget_s", 60.0)
    return RuntimeTask(key=key, fn=fn, args=args or (key,), **kw)


# ---------------------------------------------------------------------------
# parity with the JAX package: journal lines and chaos draws
# ---------------------------------------------------------------------------

JOURNAL_ENTRIES = [
    ("spec:tp_layer-0123456789ab:mn400000",
     {"verdict": "certificate", "r_o": {"t2": "t3@tp0"}}),
    ("spec:sp_rope-ba9876543210:mn400000:xp",
     {"verdict": "refinement_error", "localization": {
         "op_index": 2, "op_name": "mul", "out_name": "t2"}}),
    ("k", {"verdict": "certificate", "nested": [1, 2.5, None, "ü"],
           "degree": [4, 2]}),
]


@pytest.mark.parametrize("key,value", JOURNAL_ENTRIES)
def test_journal_line_bytes_match_the_jax_package(key, value):
    line = _line_for(key, value)
    assert line == jax_line_for(key, value)
    assert _parse_line(line) == {"k": key, "v": value}


def test_chaos_draws_match_the_jax_package():
    rnd = random.Random(15)
    for _ in range(1000):
        mode = rnd.choice(chaos.MODES)
        key = f"task{rnd.randrange(50)}@deg{rnd.choice((2, 4, 8))}"
        attempt, seed = rnd.randrange(5), rnd.randrange(100)
        p = rnd.random()
        spec = f"{mode}:{p}"
        mine = chaos.parse_spec(spec, seed=seed)
        ref = jax_chaos.parse_spec(spec, seed=seed)
        assert chaos._draw(mine, mode, key, attempt) == \
            jax_chaos._draw(ref, mode, key, attempt)
        assert chaos.should(mode, key, attempt, mine) == \
            jax_chaos.should(mode, key, attempt, ref)
    assert (chaos.ENV_SPEC, chaos.ENV_TARGET, chaos.ENV_SEED) == \
        (jax_chaos.ENV_SPEC, jax_chaos.ENV_TARGET, jax_chaos.ENV_SEED)


# ---------------------------------------------------------------------------
# certificate cache
# ---------------------------------------------------------------------------

class TestCertificateCache:
    def test_roundtrip_and_stats(self, tmp_path):
        c = CertificateCache(tmp_path / "c")
        assert c.get("k1") is None           # miss
        c.put("k1", {"verdict": "certificate", "r_o": {"y": "x"}})
        assert c.get("k1") == {"verdict": "certificate", "r_o": {"y": "x"}}
        assert "k1" in c and len(c) == 1
        s = c.stats()
        assert (s["hits"], s["misses"], s["entries"]) == (1, 1, 1)
        c2 = CertificateCache(tmp_path / "c")
        assert c2.get("k1")["r_o"] == {"y": "x"}
        assert c2.recovered_corrupt == 0

    def test_get_returns_defensive_copy(self, tmp_path):
        c = CertificateCache(tmp_path / "c")
        c.put("k", {"verdict": "certificate", "r_o": {"y": "x"}})
        c.get("k")["r_o"]["y"] = "tampered"
        assert c.get("k")["r_o"] == {"y": "x"}

    def test_torn_tail_line_recovered(self, tmp_path):
        c = CertificateCache(tmp_path / "c")
        for i in range(3):
            c.put(f"k{i}", {"verdict": "certificate", "i": i})
        raw = open(c.journal_path, "rb").read()
        torn_at = len(raw) - (len(raw) - raw[:-1].rfind(b"\n") - 1) // 2
        with open(c.journal_path, "wb") as f:
            f.write(raw[:torn_at])
        c2 = CertificateCache(tmp_path / "c")
        assert c2.recovered_corrupt == 1
        assert len(c2) == 2 and "k2" not in c2
        assert c2.get("k0") == {"verdict": "certificate", "i": 0}

    def test_garbage_and_bad_digest_lines_skipped(self, tmp_path):
        c = CertificateCache(tmp_path / "c")
        c.put("good", {"verdict": "certificate"})
        with open(c.journal_path, "ab") as f:
            f.write(b"\x00\xffnot even text\n")
            line = _line_for("evil", {"verdict": "certificate"})
            f.write(line[:17] + b"X" + line[18:])
        c2 = CertificateCache(tmp_path / "c")
        assert c2.recovered_corrupt == 2
        assert len(c2) == 1 and "evil" not in c2

    def test_compact_drops_corruption(self, tmp_path):
        c = CertificateCache(tmp_path / "c")
        c.put("a", {"verdict": "certificate"})
        c.put("b", {"verdict": "certificate"})
        with open(c.journal_path, "ab") as f:
            f.write(b"garbage line\n")
        c.compact()
        lines = open(c.journal_path, "rb").read().splitlines()
        assert len(lines) == 2
        c2 = CertificateCache(tmp_path / "c")
        assert len(c2) == 2 and c2.recovered_corrupt == 0

    def test_engine_fingerprint_rotation(self, tmp_path):
        d = tmp_path / "c"
        c = CertificateCache(d)
        c.put("k", {"verdict": "certificate"})
        meta = json.load(open(d / "meta.json"))
        meta["engine"] = "0" * len(meta["engine"])
        json.dump(meta, open(d / "meta.json", "w"))
        c2 = CertificateCache(d)
        assert len(c2) == 0
        assert os.path.exists(str(d / "journal.jsonl") + ".stale")
        c2.put("k", {"verdict": "certificate"})
        assert len(CertificateCache(d)) == 1

    def test_resolve_cache_semantics(self, tmp_path, monkeypatch):
        assert resolve_cache(False) is None
        assert resolve_cache(None) is None           # no env, no cache
        # the JAX package's variable is not the port's
        monkeypatch.setenv("GRAPHGUARD_CACHE_DIR", str(tmp_path / "jax"))
        assert resolve_cache(None) is None
        monkeypatch.setenv(ENV_CACHE_DIR, str(tmp_path / "env"))
        assert ENV_CACHE_DIR == "GRAPHGUARD_TORCH_CACHE_DIR"
        assert resolve_cache(None).dir == str(tmp_path / "env")
        assert resolve_cache(False) is None          # False beats the env
        monkeypatch.chdir(tmp_path)
        assert resolve_cache(True).dir == DEFAULT_CACHE_DIR \
            == ".graphguard_cache_torch"
        assert not (tmp_path / ".graphguard_cache").exists()
        c = resolve_cache(tmp_path / "explicit")
        assert isinstance(c, CertificateCache)
        assert resolve_cache(c) is c

    def test_cache_keys_embed_engine_limits(self):
        s2 = strategy_cache_key(build_spec("tp_layer", degree=2,
                                           device="cpu"))
        assert s2.startswith("spec:tp_layer-") and s2.endswith(":mn400000")
        assert s2 != strategy_cache_key(build_spec("sp_rope", degree=2,
                                                   device="cpu"))
        assert s2 != strategy_cache_key(build_spec("tp_layer", degree=4,
                                                   device="cpu"))
        assert s2 != strategy_cache_key(
            build_spec("tp_layer", degree=2, device="cpu"),
            {"max_nodes": 7})
        assert s2 == strategy_cache_key(build_spec("tp_layer", degree=2,
                                                   device="cpu"))
        assert strategy_cache_key(build_spec("tp_layer", device="cpu"),
                                  {"explain": True}).endswith(":xp")

    def test_commit_policy_only_deterministic_verdicts(self):
        assert cacheable_report({"verdict": "certificate"})
        assert cacheable_report({"verdict": "refinement_error"})
        assert not cacheable_report({"verdict": "error"})
        assert not cacheable_report({"verdict": "timeout"})
        assert not cacheable_report("certificate")


# ---------------------------------------------------------------------------
# chaos config
# ---------------------------------------------------------------------------

class TestChaos:
    def test_parse_spec(self):
        cfg = chaos.parse_spec("crash:0.3, hang:0.1", target="tp", seed=7)
        assert cfg.p("crash") == 0.3 and cfg.p("hang") == 0.1
        assert cfg.p("exit") == 0.0
        with pytest.raises(ValueError, match="unknown chaos mode"):
            chaos.parse_spec("explode:1")
        with pytest.raises(ValueError, match="not mode:prob"):
            chaos.parse_spec("crash")
        with pytest.raises(ValueError, match="must be in"):
            chaos.parse_spec("crash:1.5")

    def test_should_is_deterministic_and_targeted(self):
        cfg = chaos.parse_spec("crash:1", target="victim")
        assert chaos.should("crash", "the-victim-task", cfg=cfg)
        assert not chaos.should("crash", "innocent", cfg=cfg)
        assert not chaos.should("hang", "the-victim-task", cfg=cfg)
        half = chaos.parse_spec("crash:0.5", seed=3)
        draws = [chaos.should("crash", "k", a, half) for a in range(64)]
        assert draws == [chaos.should("crash", "k", a, half)
                         for a in range(64)]
        assert any(draws) and not all(draws)

    def test_maybe_fault_is_noop_outside_workers(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_SPEC, "crash:1,exit:1,hang:1")
        chaos.maybe_fault("anything")    # would SIGSEGV us in a worker
        assert chaos.load_config().p("crash") == 1.0


# ---------------------------------------------------------------------------
# pool semantics (spawned workers)
# ---------------------------------------------------------------------------

class TestPool:
    def test_workers_are_always_spawned(self):
        with SupervisedPool(1, **BARE) as pool:
            assert pool._ctx.get_start_method() == "spawn"
        assert pool_mod.START_METHOD == "spawn"

    def test_only_workers_import_the_callers_main(self, tmp_path):
        """A script's pool re-runs the script in each spawned worker (as
        ``__mp_main__``), not in the heartbeat manager."""
        log = tmp_path / "imports.log"
        script = tmp_path / "pool_script.py"
        script.write_text(tasks.pool_script(str(log)))
        here = os.path.dirname(os.path.abspath(__file__))
        r = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [os.path.join(os.path.dirname(here), "src"), here])))
        assert r.returncode == 0, r.stderr
        assert sorted(log.read_text().split()) == \
            ["__main__", "__mp_main__", "__mp_main__"]

    def test_inline_execution(self):
        out = execute_inline([_task("a"), _task("b")])
        assert out["a"].ok and out["a"].value == tasks.report("a")
        assert out["b"].ok
        assert out["a"].runtime_info() == {}

    def test_inline_task_error_contained(self):
        out = execute_inline([_task("bad", fn=tasks.boom), _task("good")])
        assert out["bad"].status == "error"
        assert "synthetic failure" in out["bad"].error
        assert out["good"].ok

    def test_pool_matches_inline_and_contains_task_errors(self):
        ts = [_task(f"t{i}") for i in range(4)] + [_task("bad",
                                                         fn=tasks.boom)]
        pooled = run_tasks(ts, workers=2, **BARE)
        inline = run_tasks(ts, workers=0)
        for k in (f"t{i}" for i in range(4)):
            assert pooled[k].ok and pooled[k].value == inline[k].value
            assert pooled[k].runtime_info() == inline[k].runtime_info() == {}
        assert pooled["bad"].status == "error"
        assert "synthetic failure" in pooled["bad"].error

    def test_duplicate_keys_rejected(self):
        with SupervisedPool(2, **BARE) as pool:
            with pytest.raises(ValueError, match="duplicate task keys"):
                pool.execute([_task("dup"), _task("dup")])

    def test_per_task_budget_not_shared(self):
        """One slow task exhausts only its own budget — queued siblings
        still get their full budget and finish."""
        ts = [_task("slow", fn=tasks.sleep_report, args=("slow", 3600.0),
                    budget_s=3.0)]
        ts += [_task(f"quick{i}") for i in range(3)]
        out = run_tasks(ts, workers=2, **BARE)
        assert out["slow"].status == "timeout"
        assert "budget" in out["slow"].error
        assert out["slow"].wall_s >= 3.0
        for i in range(3):
            q = out[f"quick{i}"]
            assert q.ok and q.attempts == 1

    def test_crash_blamed_on_victim_only(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_SPEC, "crash:1")
        monkeypatch.setenv(chaos.ENV_TARGET, "victim")
        out = run_tasks([_task("victim"), _task("bystander-a"),
                         _task("bystander-b")], workers=2, **BARE)
        v = out["victim"]
        assert v.status == "error" and v.attempts == 3
        assert "all 3 attempts" in v.error and "SIGSEGV" in v.error
        for k in ("bystander-a", "bystander-b"):
            assert out[k].ok and out[k].value == tasks.report(k)
            assert out[k].attempts == 1

    def test_hard_exit_cause_reported(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_SPEC, "exit:1")
        monkeypatch.setenv(chaos.ENV_TARGET, "victim")
        out = run_tasks([_task("victim"), _task("ok")], workers=2, **BARE)
        assert out["victim"].status == "error"
        assert "exit code 3" in out["victim"].error
        assert out["ok"].ok

    def test_transient_crash_recovers_with_retry(self, monkeypatch):
        """A fault on the first attempt only: the quarantine retry gets a
        clean result and reports attempts > 1."""
        def cfg(seed):
            return chaos.parse_spec("crash:0.5", target="flaky", seed=seed)
        seed = next(s for s in range(1000)
                    if chaos.should("crash", "flaky", 1, cfg(s))
                    and not chaos.should("crash", "flaky", 2, cfg(s)))
        monkeypatch.setenv(chaos.ENV_SPEC, "crash:0.5")
        monkeypatch.setenv(chaos.ENV_TARGET, "flaky")
        monkeypatch.setenv(chaos.ENV_SEED, str(seed))
        out = run_tasks([_task("flaky")], workers=2, **BARE)
        assert out["flaky"].ok and out["flaky"].value == tasks.report("flaky")
        assert out["flaky"].attempts == 2
        assert out["flaky"].runtime_info() == {"attempts": 2}

    def test_wedged_worker_startup_times_out(self):
        """A worker that wedges before its first heartbeat burns the
        pool's start-up deadline from executor pick-up instead of hanging
        execute() forever (the task's budget starts at its start beat)."""
        with SupervisedPool(2, **BARE) as pool:
            pool._initializer = tasks.wedge_forever
            pool.startup_s = 3.0
            out = pool.execute([_task("stuck", budget_s=3.0)])
        assert out["stuck"].status == "timeout"
        assert "wedged during startup" in out["stuck"].error
        assert out["stuck"].wall_s >= 2.5

    def test_worker_dying_in_startup_is_bounded(self):
        """Workers that die before any task starts break the pool each
        time; after the retry bound every task gets an error naming the
        exit cause instead of the pool being rebuilt forever."""
        with SupervisedPool(2, backoff_s=0.0, **BARE) as pool:
            pool._initializer = tasks.die_in_startup
            out = pool.execute([_task("a"), _task("b")])
        for k in ("a", "b"):
            assert out[k].status == "error"
            assert "before the task started" in out[k].error
            assert "exit code 7" in out[k].error

    def test_worker_without_the_device_errors_each_task(self):
        """A warm worker that cannot reach its device answers each task
        with an error naming it; nothing runs on another device."""
        with SupervisedPool(1, device="meta") as pool:
            out = pool.execute([_task("a"), _task("b")])
        for k in ("a", "b"):
            assert out[k].status == "error"
            assert "worker cannot reach meta" in out[k].error

    def test_degrades_inline_when_pool_unavailable(self, monkeypatch):
        pool = SupervisedPool(2, **BARE)

        def no_pool(size):
            raise PoolUnavailable("no child processes on this host")
        monkeypatch.setattr(pool, "_make_executor", no_pool)
        try:
            out = pool.execute([_task("a"), _task("b")])
        finally:
            pool.shutdown()
        for k in ("a", "b"):
            assert out[k].ok and out[k].value == tasks.report(k)
            assert "no child processes" in out[k].degraded_reason
            assert "degraded_reason" in out[k].runtime_info()

    def test_worker_chaos_never_fires_in_process(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_SPEC, "crash:1,exit:1,hang:1")
        out = run_tasks([_task("a")], workers=0)
        assert out["a"].ok

    def test_pool_cache_hit_skips_execution(self, tmp_path):
        cache = CertificateCache(tmp_path / "c")
        sentinel = {"verdict": "certificate", "tag": "from-cache"}
        cache.put("ck-hit", sentinel)
        out = run_tasks([_task("hit", cache_key="ck-hit"),
                         _task("miss", cache_key="ck-miss")],
                        workers=2, cache=cache, **BARE)
        assert out["hit"].value == sentinel
        assert out["hit"].cache == "hit" and out["hit"].attempts == 0
        assert out["miss"].cache == "miss"
        assert cache.get("ck-miss") == tasks.report("miss")

    def test_nondeterministic_verdicts_never_cached(self, tmp_path):
        cache = CertificateCache(tmp_path / "c")
        out = execute_inline([_task("e", fn=tasks.nondeterministic_report,
                                    cache_key="ck-e")], cache=cache)
        assert out["e"].ok and out["e"].cache == "miss"
        assert "ck-e" not in cache
