"""Quickstart: verify a tensor-parallel transformer layer with GraphGuard,
then catch an injected distribution bug — via the typed
``repro_torch.api``.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
import argparse
import sys

from repro_torch.api import verify


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device

    # 1. A correct Megatron-style TP transformer layer: refinement holds and
    #    we get an executable certificate R_o (report.certificate is the
    #    live object; report.r_o the stringified relation).
    report = verify("tp_layer", degree=2, device=device)
    assert report.verdict == "certificate" and report.ok
    print("\n[1] TP layer verified — certificate maps the sequential output "
          "to", list(report.r_o.values())[0], "\n")

    # 2. Paper bug 4: a rotated expert-to-shard mapping — each rank applies
    #    its neighbour's expert weights and GraphGuard localizes the matmul.
    report = verify("ep_moe", bug="sharded_expert", device=device)
    if report.verdict != "refinement_error":
        print("[2] UNEXPECTED: bug not detected")
        return 1
    loc = report.localization
    print("[2] injected bug detected at G_s operator "
          f"#{loc['op_index']} `{loc['op_name']}` (output `{loc['out_name']}`)")
    print("    nearest candidate:", loc.get("diagnostic", {}).get("expr"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
