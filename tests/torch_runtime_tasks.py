"""Picklable task functions for the port's runtime tests.

Spawned pool workers import the module of every function they run, so
these live apart from the test files: this module imports neither JAX nor
any test module, and nothing heavier than the standard library.
"""
import time


def report(tag):
    return {"verdict": "certificate", "tag": tag}


def nondeterministic_report(tag):
    return {"verdict": "error", "tag": tag}


def sleep_report(tag, seconds):
    time.sleep(seconds)
    return {"verdict": "certificate", "tag": tag}


def boom(tag):
    raise RuntimeError(f"synthetic failure for {tag}")


def wedge_forever():
    time.sleep(3600)


def die_in_startup():
    import os
    os._exit(7)


def rendezvous_nap(started, n, seconds):
    """Check in, wait until ``n`` tasks have checked in (so each runs on
    its own worker), then nap."""
    import os
    started[os.getpid()] = True
    deadline = time.time() + 120.0
    while len(started) < n and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(seconds)
    return {"verdict": "certificate", "pid": os.getpid()}


def pool_script(log_path: str) -> str:
    """A script that starts a pool of two bare workers and notes each
    import of itself (as ``__main__`` or, in a spawned child,
    ``__mp_main__``) in ``log_path``."""
    return f"""
import sys
with open({log_path!r}, "a") as f:
    f.write(__name__ + "\\n")
from repro_torch.runtime import RuntimeTask, run_tasks
import torch_runtime_tasks as tasks

if __name__ == "__main__":
    out = run_tasks([RuntimeTask(key=k, fn=tasks.report, args=(k,),
                                 budget_s=60.0) for k in "ab"],
                    workers=2, warm=False)
    sys.exit(0 if all(o.ok for o in out.values()) else 1)
"""


class UnreachableBeats(dict):
    """A heartbeat channel that no worker can write to (a Manager the
    worker cannot reach): every write raises, the parent reads nothing."""

    def __setitem__(self, key, value):
        raise ConnectionRefusedError("heartbeat manager unreachable")
