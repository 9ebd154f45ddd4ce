"""Verify YOUR OWN distributed torch function — no registry, no hand-built
terms.

The generic frontend (``repro_torch.core.from_fx`` +
``repro_torch.api.verify_functions``) traces any sequential/distributed
function pair you wrote, the distributed one on ``repro_torch.core.spmd``'s
collectives, so verification is one call:

    PYTHONPATH=src python -m repro_torch.verify_your_own_fn [--device cpu]

The same task also runs through the CLI:

    PYTHONPATH=src python -m repro_torch.launch.verify \\
        --fn repro_torch.verify_your_own_fn:make_task --json [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
import argparse
import sys

import torch

from repro_torch.core.spmd import PartitionSpec as P
from repro_torch.core.spmd import psum

DEGREE = 2          # tensor-parallel ranks
SEQ, D_MODEL, D_FF = 4, 8, 8


# -- 1. the model you trust: a plain sequential MLP -------------------------

def seq_mlp(x, w1, w2):
    """The sequential reference: y = tanh(x @ w1) @ w2."""
    return torch.tanh(x @ w1) @ w2


# -- 2. the distributed implementation you wrote ----------------------------
# Megatron-style tensor parallelism: w1 column-sharded, w2 row-sharded, so
# each rank holds partial sums that a psum over the `tp` axis assembles.

def dist_mlp(x, w1, w2):
    """Per-rank TP implementation: partial matmuls + psum over `tp`."""
    h = torch.tanh(x @ w1)        # x replicated, w1 column shard
    return psum(h @ w2, "tp")


def dist_mlp_buggy(x, w1, w2):
    """A classic mistake: 'averaging' the psum as if shards were replicas.

    The per-rank products are *partial sums*, not copies — dividing by the
    rank count halves the result.
    """
    h = torch.tanh(x @ w1)
    return psum(h @ w2, "tp") / DEGREE      # BUG: not an average!


def make_task():
    """Task description for the CLI: ``--fn <this module>:make_task``."""
    avals = [(s, torch.float32)
             for s in ((SEQ, D_MODEL), (D_MODEL, D_FF), (D_FF, D_MODEL))]
    return {
        "fn_seq": seq_mlp,
        "fn_dist": dist_mlp,
        "mesh": {"tp": DEGREE},
        "in_specs": (P(), P(None, "tp"), P("tp", None)),
        "avals": avals,
        "name": "my_tp_mlp",
    }


def make_buggy_task():
    """The buggy variant, for ``--fn <this module>:make_buggy_task``."""
    return {**make_task(), "fn_dist": dist_mlp_buggy,
            "name": "my_tp_mlp_buggy"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device
    from repro_torch.api import verify_functions

    task = make_task()

    # the correct implementation certifies: R_o maps each sequential output
    # to a clean expression over per-rank outputs
    report = verify_functions(**task, device=device)
    if report.verdict != "certificate":
        print(f"[1] UNEXPECTED: {report.verdict} ({report.error})")
        return 1
    print("[1] your TP MLP verified — certificate:")
    for k, v in report.r_o.items():
        print(f"      {k} = {v}")

    # the buggy variant is caught and localized — no test data needed
    report = verify_functions(**make_buggy_task(), device=device)
    if report.verdict != "refinement_error":
        print(f"[2] UNEXPECTED: bug not detected ({report.verdict})")
        return 1
    loc = report.localization
    print(f"\n[2] buggy variant rejected — localized at G_s operator "
          f"#{loc['op_index']} `{loc['op_name']}` (output `{loc['out_name']}`)")

    # code outside the term vocabulary fails *loudly*, naming the op and
    # your source line — not with a confusing downstream verdict
    def dist_sorted(x, w1, w2):
        return torch.sort(psum(torch.tanh(x @ w1) @ w2, "tp"), dim=0)[0]

    report = verify_functions(**{**task, "fn_dist": dist_sorted,
                                 "name": "my_sorted_mlp"}, device=device)
    if report.verdict != "error" or "sort" not in report.error:
        print(f"[3] UNEXPECTED: {report.verdict} ({report.error})")
        return 1
    print(f"\n[3] unsupported code is named at its source:\n"
          f"      {report.error.splitlines()[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
