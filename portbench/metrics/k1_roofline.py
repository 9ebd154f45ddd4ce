"""k1_roofline: K1 RMSNorm's share of its roofline, forward and backward
(the bytes each call needs at the memory peak, summed over the norms'
widths (``counts.k1_norms``), over K1's device time)."""
from portbench import counts, readers

FORWARD = ("rmsnorm_rows", "rmsnorm_ring")
BACKWARD = ("rmsnorm_bwd",)          # and its column sum, rmsnorm_bwd_colsum


def read(run):
    norms = counts.k1_norms(run.config)
    train = run.mix["driver"] == "train"
    peak = run.peaks["bytes"]
    fwd = readers.roofline_share(
        run, FORWARD, FORWARD + BACKWARD,
        lambda seqs: [(n, counts.k1_forward_bytes(sum(seqs), D) / peak)
                      for n, D in norms])
    if fwd is None:
        return None
    if not train:
        return fwd
    # both directions: the bounds of both over the time of both
    bwd = readers.roofline_share(
        run, BACKWARD, FORWARD + BACKWARD,
        lambda seqs: [(n, counts.k1_backward_bytes(sum(seqs), D) / peak)
                      for n, D in norms],
        exclude=("colsum",))
    return None if bwd is None else fwd + bwd
