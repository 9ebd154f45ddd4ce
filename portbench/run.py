"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. The last line
of standard output is the result (JSON); the numbers the check compared,
each beside its limit, are the last lines of standard error. Exits 2
without a result where the cell's cards are missing or the program is not
beside the benchmark.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
THREADS = 2          # host threads for torch's CPU ops (the card does the work)


def power_limit():
    """The card's power limit in W, as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program beside the benchmark: {ROOT / 'src' / 'repro_torch'} "
              "is missing", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from portbench import bench
    spec = bench.load_bench()
    cell = bench.find_cell(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    torch.cuda.init()
    watts = power_limit()
    run = bench.Run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                    T_START, bench=spec)
    result = bench.run_cell(run)
    result["device"]["power_limit_w"] = watts
    checks = result.pop("checks")
    result["checks"] = checks
    alloc = torch.cuda.memory_stats()
    print(f"allocator: {alloc.get('num_alloc_retries', 0)} retries, "
          f"{alloc.get('num_device_alloc', 0)} device allocations",
          file=sys.stderr)
    print(f"window {run.window_s:.3f} s, check {run.check_s:.3f} s"
          + (f", kernels attributed by {run.stretch['attributed_by']}"
             if run.stretch else ""), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
