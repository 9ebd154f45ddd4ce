"""k1_roofline: K1 RMSNorm's share of its roofline, forward and backward
(the bytes each call needs at the memory peak, over K1's device time)."""
from portbench import counts, readers

FORWARD = ("rmsnorm_rows", "rmsnorm_ring")
BACKWARD = ("rmsnorm_bwd",)          # and its column sum, rmsnorm_bwd_colsum


def read(run):
    c = run.config
    D, L = c["hidden_size"], c["num_hidden_layers"]
    train = run.mix["driver"] == "train"
    norms = 2 * L + 1                # before attention and MLP, and the last
    peak = run.peaks["bytes"]
    fwd = readers.roofline_share(
        run, FORWARD, FORWARD + BACKWARD, norms,
        lambda seqs: counts.k1_forward_bytes(sum(seqs), D) / peak)
    if fwd is None:
        return None
    if not train:
        return fwd
    # both directions: the bounds of both over the time of both
    bwd = readers.roofline_share(
        run, BACKWARD, FORWARD + BACKWARD, norms,
        lambda seqs: counts.k1_backward_bytes(sum(seqs), D) / peak,
        exclude=("colsum",))
    return None if bwd is None else fwd + bwd
