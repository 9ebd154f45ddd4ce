"""Crash-safe persistent certificate cache.

A suite run re-proves every task; this module makes proved reports
persist *across* runs, so a repeat run is served from disk and an
interrupted run resumes from its last committed entry.

Storage model — append-only journal with atomic-rename commits (the JAX
package's format, line for line):

* One directory per cache (``CertificateCache(path)``), holding
  ``meta.json`` (schema + engine fingerprint, written via temp-file +
  ``os.replace`` so it is never observed half-written) and
  ``journal.jsonl``.
* Each ``put`` appends one line — ``<sha256-prefix> <json payload>`` —
  then flushes and fsyncs.  An entry is *committed* once its line is
  fully on disk; a crash mid-append leaves at most one torn tail line.
* Recovery is corruption-tolerant by construction: a line that fails the
  checksum or does not parse is counted and *skipped* — the task is
  simply re-proved and re-committed.  Corruption is never fatal.
* ``compact()`` rewrites the journal (last write per key wins, corrupt
  lines dropped) through a temp file + atomic ``os.replace``.
* A cache written by a different engine (any source change under the
  fingerprinted parts of this package) is invalidated wholesale on open:
  the stale journal is rotated aside, never reinterpreted.

The port's cache lives apart from the JAX package's: its own default
directory (``.graphguard_cache_torch``) and its own variable
(``$GRAPHGUARD_TORCH_CACHE_DIR``).  The two engines have different
fingerprints, so a shared directory would be rotated aside by whichever
package opened it last.

Keys are *content-addressed*: the suite keys by
:func:`strategy_cache_key` (mesh + shapes + dtypes + input specs + task
identity), and every key embeds the engine-side knobs that can change an
outcome (``max_nodes``, explanations).  Only deterministic verdicts
(``certificate`` / ``refinement_error``) are ever stored — ``error`` and
``timeout`` reflect the environment, not the task.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from functools import lru_cache
from typing import Any, Dict, Optional, Union

from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY
from . import chaos

CACHE_SCHEMA = 1

# default location; overridable per call and via the environment
ENV_CACHE_DIR = "GRAPHGUARD_TORCH_CACHE_DIR"
DEFAULT_CACHE_DIR = ".graphguard_cache_torch"

# verdicts that are a function of the task (cacheable) rather than
# of the machine the run happened to land on (never cached)
DETERMINISTIC_VERDICTS = ("certificate", "refinement_error")


# ---------------------------------------------------------------------------
# content-addressed keys
# ---------------------------------------------------------------------------

def spec_token(spec) -> str:
    """Stable string form of a ``spmd.PartitionSpec`` (or None)."""
    if spec is None:
        return "-"
    entries = []
    for e in tuple(spec):
        if e is None:
            entries.append("_")
        elif isinstance(e, tuple):
            entries.append("(" + "+".join(map(str, e)) + ")")
        else:
            entries.append(str(e))
    return "P[" + ",".join(entries) + "]"


def aval_token(aval) -> str:
    """``(8, 4):float32`` for a ``TensorSpec`` (or any ``(shape, dtype)``
    pair), spelled as the JAX package spells its avals."""
    shape, dtype = aval
    return f"{tuple(shape)}:{str(dtype).removeprefix('torch.')}"


@lru_cache(maxsize=1)
def engine_fingerprint() -> str:
    """Hash of every source file of this package whose semantics a cached
    certificate depends on: the engine and capture (``core``), the case
    builders (``dist``), the task model (``api/spec.py``) and the runner
    (``api/runner.py``).  Any edit invalidates the cache wholesale — the
    conservative choice; *content* keys handle the common fast path of
    unchanged code + edited task.  The device is in neither: a
    certificate is symbolic, the same on the CPU and on the card."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subdirs = ("core", "dist")
    files = [os.path.join(pkg, "api", "spec.py"),
             os.path.join(pkg, "api", "runner.py")]
    for sub in subdirs:
        root = os.path.join(pkg, sub)
        if not os.path.isdir(root):
            continue
        for dirpath, _, names in os.walk(root):
            files.extend(os.path.join(dirpath, n)
                         for n in names if n.endswith(".py"))
    h = hashlib.sha256()
    for path in sorted(files):
        h.update(path[len(pkg):].encode())
        try:
            with open(path, "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(b"<unreadable>")
    return h.hexdigest()[:16]


def _engine_token(engine_opts: Optional[dict]) -> str:
    # max_nodes bounds the e-graph and can truncate a proof; optimization
    # flags are certified byte-identical and excluded.  explain changes
    # the report payload (lemma chains attached), so explain-on runs must
    # not be served explain-off cache entries — the env-ambient default
    # counts too, not just the explicit option
    from ..api.runner import DEFAULT_MAX_NODES
    from ..core.profile import explain_enabled
    tok = f"mn{(engine_opts or {}).get('max_nodes', DEFAULT_MAX_NODES)}"
    if explain_enabled((engine_opts or {}).get("explain")):
        tok += ":xp"
    return tok


def strategy_cache_key(spec, engine_opts: Optional[dict] = None) -> str:
    """Content-addressed key for a :class:`repro_torch.api.StrategySpec` —
    mesh + shapes + dtypes + input specs + task identity, hashed short."""
    mesh = dict(spec.mesh_axes) if not isinstance(spec.mesh_axes, dict) \
        else spec.mesh_axes
    parts = [
        "name=" + spec.name,
        "bug=" + (spec.bug or "-"),
        "mesh=" + ",".join(f"{a}{s}" for a, s in mesh.items()),
        "in=" + ";".join(f"{n}:{aval_token(a)}:{spec_token(s)}"
                         for n, a, s in zip(spec.input_names, spec.avals,
                                            spec.in_specs)),
    ]
    digest = hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]
    return f"spec:{spec.name}-{digest}:{_engine_token(engine_opts)}"


def cacheable_report(value: Any) -> bool:
    """Default commit policy: only deterministic verdicts persist."""
    return (isinstance(value, dict)
            and value.get("verdict") in DETERMINISTIC_VERDICTS)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

_DIGEST_LEN = 16


def _line_for(key: str, value: dict) -> bytes:
    payload = json.dumps({"k": key, "v": value}, sort_keys=True,
                         separators=(",", ":"))
    digest = hashlib.sha256(payload.encode()).hexdigest()[:_DIGEST_LEN]
    return f"{digest} {payload}\n".encode()


def _parse_line(raw: bytes) -> Optional[Dict[str, Any]]:
    """Decode one journal line; None for torn/garbage/corrupt lines."""
    try:
        text = raw.decode()
    except UnicodeDecodeError:
        return None
    digest, sep, payload = text.rstrip("\n").partition(" ")
    if not sep or len(digest) != _DIGEST_LEN:
        return None
    if hashlib.sha256(payload.encode()).hexdigest()[:_DIGEST_LEN] != digest:
        return None
    try:
        entry = json.loads(payload)
    except json.JSONDecodeError:
        return None
    if not isinstance(entry, dict) or "k" not in entry or "v" not in entry:
        return None
    return entry


class CertificateCache:
    """Persistent content-addressed report cache over an append-only
    journal.  Safe against crashes of the *writer* (torn tail line) and
    against arbitrary corruption of the *file* (bad lines are skipped and
    re-proved); not designed for concurrent writers."""

    def __init__(self, path: Union[str, os.PathLike]):
        self.dir = os.fspath(path)
        os.makedirs(self.dir, exist_ok=True)
        self.journal_path = os.path.join(self.dir, "journal.jsonl")
        self._mem: Dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self.recovered_corrupt = 0       # bad lines skipped during load
        self._check_meta()
        self._load()

    # -- fingerprint gate ---------------------------------------------------
    def _check_meta(self) -> None:
        meta_path = os.path.join(self.dir, "meta.json")
        want = {"schema": CACHE_SCHEMA, "engine": engine_fingerprint()}
        try:
            with open(meta_path) as f:
                have = json.load(f)
        except (OSError, json.JSONDecodeError):
            have = None
        if have != want:
            # stale or foreign cache: rotate the journal aside rather than
            # reinterpret entries proved by a different engine
            if os.path.exists(self.journal_path) \
                    and os.path.getsize(self.journal_path):
                os.replace(self.journal_path, self.journal_path + ".stale")
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(want, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, meta_path)   # atomic-rename commit

    # -- journal ------------------------------------------------------------
    def _load(self) -> None:
        if not os.path.exists(self.journal_path):
            return
        with open(self.journal_path, "rb") as f:
            for raw in f:
                entry = _parse_line(raw)
                if entry is None:
                    self.recovered_corrupt += 1
                    continue
                self._mem[entry["k"]] = entry["v"]

    def get(self, key: str) -> Optional[dict]:
        v = self._mem.get(key)
        result = "miss" if v is None else "hit"
        obs_trace.event("cache.probe", cat="cache", key=key.split(":", 1)[0],
                        digest=key[-12:], result=result)
        REGISTRY.counter("cache.hits" if v is not None
                         else "cache.misses").inc()
        if v is None:
            self.misses += 1
            return None
        self.hits += 1
        return json.loads(json.dumps(v))     # defensive copy

    def put(self, key: str, value: dict) -> None:
        """Commit one entry: append + flush + fsync.  The entry is durable
        (and will be resumed from) once this returns."""
        obs_trace.event("cache.commit", cat="cache",
                        key=key.split(":", 1)[0], digest=key[-12:])
        REGISTRY.counter("cache.commits").inc()
        line = _line_for(key, value)
        with open(self.journal_path, "ab") as f:
            offset = f.tell()
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        self._mem[key] = value
        if chaos.corrupt_cache_entry(key):
            self._corrupt_at(offset, len(line))

    def _corrupt_at(self, offset: int, length: int) -> None:
        """Chaos hook: flip one byte inside the just-committed payload
        (simulating a torn write / bit rot the next load must survive)."""
        with open(self.journal_path, "r+b") as f:
            f.seek(offset + min(_DIGEST_LEN + 2, length - 2))
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
            f.flush()
            os.fsync(f.fileno())

    def compact(self) -> None:
        """Rewrite the journal (one line per live key, corruption dropped)
        via temp file + atomic ``os.replace``."""
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            for key in sorted(self._mem):
                f.write(_line_for(key, self._mem[key]))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.journal_path)

    # -- views --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: str) -> bool:
        return key in self._mem

    def stats(self) -> dict:
        return {
            "dir": self.dir,
            "entries": len(self._mem),
            "hits": self.hits,
            "misses": self.misses,
            "recovered_corrupt": self.recovered_corrupt,
        }


def resolve_cache(cache: Union[None, bool, str, os.PathLike,
                               CertificateCache]
                  ) -> Optional[CertificateCache]:
    """Normalize the ``cache=`` argument the schedulers accept.

    ``None`` consults ``$GRAPHGUARD_CACHE_DIR`` (set → cache on at that
    path; unset → no cache), ``False`` disables explicitly, ``True``
    uses the default location, a path opens that directory, and an
    existing :class:`CertificateCache` passes through.
    """
    if cache is False:
        return None
    if cache is None:
        env = os.environ.get(ENV_CACHE_DIR)
        return CertificateCache(env) if env else None
    if cache is True:
        return CertificateCache(DEFAULT_CACHE_DIR)
    if isinstance(cache, CertificateCache):
        return cache
    return CertificateCache(cache)
