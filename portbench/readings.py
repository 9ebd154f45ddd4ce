"""The readings that the check's limits are set from, on the card, at a
cell's own size, in one process: for each seed, a run with a short window
(the program's numbers, beside their current limits) and, on the control
seeds, the control (the reference's products in float8) and, for a
training cell, the half-batch fault, both put in the program's place.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 3 --out <file.json>

Writes one JSON object a seed to ``--out`` (JSON lines) and prints each.
The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import bench
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    spec = bench.load_bench()
    cell = bench.find_cell(spec, args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        run = bench.Run(cell, seed, args.seconds, False, "cuda", t, bench=spec)
        run.control = seed in controls
        res = bench.run_cell(run)
        rec = dict(workload=args.workload, seed=seed, correct=res["correct"],
                   checks=res["checks"], metrics=res["metrics"],
                   readings=run.readings,
                   device=torch.cuda.get_device_name(0))
        with out.open("a") as f:
            # tensors (the gradients' samples) stay out of the record
            f.write(json.dumps(rec, default=lambda o: None) + "\n")
        print(json.dumps({k: rec[k] for k in ("seed", "correct", "checks")}
                         | {"control": run.readings.get("control"),
                            "half_batch": run.readings.get("half_batch")},
                         default=lambda o: None),
              flush=True)
        del run
        bench.free_device()
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
