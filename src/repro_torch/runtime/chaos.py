"""Fault injection for the verification runtime (``GRAPHGUARD_CHAOS``).

The chaos harness is how we *prove* the runtime's fault tolerance instead
of asserting it: an env-gated hook makes pool workers segfault, exit, or
sleep forever, and flips bytes in the persistent certificate cache as
entries are committed — all driven from tests and ``chip_smoke.py``.

Configuration (all via environment, so child processes inherit it; the
names and the draw are the JAX package's, so one seed picks the same
victims in both packages):

    GRAPHGUARD_CHAOS=crash:0.3,hang:0.1,corrupt_cache:1
        comma-separated ``mode:probability`` pairs.  Modes:
          crash          worker raises SIGSEGV against itself (segfault)
          exit           worker hard-exits (``os._exit``) mid-task
          hang           worker sleeps "forever" (heartbeats keep beating,
                         so this exercises deadline — not liveness —
                         detection)
          corrupt_cache  the just-committed cache journal entry has one
                         payload byte flipped (a torn/garbage entry the
                         next run must skip and re-prove)
    GRAPHGUARD_CHAOS_TARGET=substr
        only afflict tasks/cache keys containing ``substr`` (empty/unset:
        every key is eligible)
    GRAPHGUARD_CHAOS_SEED=int
        seed for the deterministic per-(mode, key, attempt) draw
        (default 0)

Draws are *deterministic*: ``sha256(seed:mode:key:attempt)`` mapped to
[0, 1) and compared against the configured probability.  A probability of
1 therefore means "this key fails on every attempt" (how tests pin a
persistent fault to one task), while 0.3 means ~30% of attempts fail —
and a retry of the same key draws fresh randomness via its attempt
number.

Worker-side faults (`crash`/`exit`/`hang`) only ever fire inside a pool
worker (the shim calls :func:`enter_worker` first); the in-process
degradation path must stay safe — a segfault there would take down the
caller, which is exactly what the runtime exists to prevent.
"""
from __future__ import annotations

import hashlib
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY

ENV_SPEC = "GRAPHGUARD_CHAOS"
ENV_TARGET = "GRAPHGUARD_CHAOS_TARGET"
ENV_SEED = "GRAPHGUARD_CHAOS_SEED"

MODES = ("crash", "exit", "hang", "corrupt_cache")

# how long an injected hang sleeps — far beyond any per-task budget, so
# the supervisor's deadline (not this constant) decides when it surfaces
HANG_S = 3600.0

# set by the pool worker shim; guards the process-killing fault modes
_IN_WORKER = False


@dataclass(frozen=True)
class ChaosConfig:
    """Parsed ``GRAPHGUARD_CHAOS`` spec."""
    probabilities: Dict[str, float] = field(default_factory=dict)
    target: str = ""
    seed: int = 0

    def p(self, mode: str) -> float:
        return self.probabilities.get(mode, 0.0)


def parse_spec(spec: str, target: str = "", seed: int = 0) -> ChaosConfig:
    """Parse ``crash:0.3,hang:0.1`` into a :class:`ChaosConfig` (raising
    on unknown modes / unparsable probabilities — a typo'd chaos spec
    silently injecting nothing would defeat the harness)."""
    probs: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        mode, sep, p = part.partition(":")
        if not sep:
            raise ValueError(f"chaos spec entry `{part}` is not mode:prob")
        if mode not in MODES:
            raise ValueError(f"unknown chaos mode `{mode}` "
                             f"(valid: {', '.join(MODES)})")
        prob = float(p)
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"chaos probability for `{mode}` must be in "
                             f"[0, 1], got {prob}")
        probs[mode] = prob
    return ChaosConfig(probabilities=probs, target=target, seed=seed)


def load_config() -> Optional[ChaosConfig]:
    """The active chaos config, or None when ``GRAPHGUARD_CHAOS`` is unset.

    Read fresh on every call (not cached): tests and ``chip_smoke.py`` flip
    the env var between runs within one process, and pool workers inherit
    whatever was set when they were spawned (a pool started before the
    variable changed keeps the old setting in its workers).
    """
    spec = os.environ.get(ENV_SPEC)
    if not spec:
        return None
    return parse_spec(spec, target=os.environ.get(ENV_TARGET, ""),
                      seed=int(os.environ.get(ENV_SEED, "0")))


def _draw(cfg: ChaosConfig, mode: str, key: str, attempt: int) -> float:
    h = hashlib.sha256(
        f"{cfg.seed}:{mode}:{key}:{attempt}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


def should(mode: str, key: str, attempt: int = 0,
           cfg: Optional[ChaosConfig] = None) -> bool:
    """Deterministic: does chaos afflict (mode, key, attempt)?"""
    cfg = cfg if cfg is not None else load_config()
    if cfg is None:
        return False
    p = cfg.p(mode)
    if p <= 0.0:
        return False
    if cfg.target and cfg.target not in key:
        return False
    return p >= 1.0 or _draw(cfg, mode, key, attempt) < p


def enter_worker() -> None:
    """Mark this process as a pool worker (called by the worker shim);
    only then may :func:`maybe_fault` kill or wedge the process."""
    global _IN_WORKER
    _IN_WORKER = True


def maybe_fault(key: str, attempt: int = 0) -> None:
    """Inject a worker-side fault for (key, attempt) if chaos says so.

    ``crash`` delivers SIGSEGV to the worker itself (the classic silent
    killer from the distributed-DL bug studies), ``exit`` hard-exits
    without cleanup, ``hang`` sleeps far past any budget.  No-op outside
    a pool worker or when ``GRAPHGUARD_CHAOS`` is unset.
    """
    if not _IN_WORKER:
        return
    cfg = load_config()
    if cfg is None:
        return
    if should("crash", key, attempt, cfg):
        _note_injection("crash", key, attempt)
        signal.signal(signal.SIGSEGV, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGSEGV)
        time.sleep(HANG_S)               # pragma: no cover — never reached
    if should("exit", key, attempt, cfg):
        _note_injection("exit", key, attempt)
        os._exit(3)
    if should("hang", key, attempt, cfg):
        _note_injection("hang", key, attempt)
        time.sleep(HANG_S)


def _note_injection(mode: str, key: str, attempt: int) -> None:
    """Record the injection on the local tracer/registry.  Worker-side
    kill modes usually take the tracer down with the process — the
    supervisor's fault events are what make those visible in the merged
    trace — but ``hang`` (and any future soft mode) is captured here."""
    obs_trace.event(f"chaos.{mode}", cat="fault", key=key, attempt=attempt)
    REGISTRY.counter("chaos.injected").inc()


def corrupt_cache_entry(key: str) -> bool:
    """Should the cache flip a byte in the entry just committed for
    ``key``?  (Cache corruption is a *storage* fault, so unlike the
    worker faults it may fire in any process.)"""
    hit = should("corrupt_cache", key)
    if hit:
        obs_trace.event("chaos.corrupt_cache", cat="fault",
                        key=key.split(":", 1)[0], digest=key[-12:])
        REGISTRY.counter("chaos.injected").inc()
    return hit
