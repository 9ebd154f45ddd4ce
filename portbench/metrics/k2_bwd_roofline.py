"""k2_bwd_roofline: K2's backward share of its roofline (five products,
``counts.k2_backward_ops``: 2.5x the forward's operations where q and v
share a head size), over the device time of its kernels (prologue, dK/dV,
dQ, the GQA sum)."""
from portbench import counts, readers

MAIN = ("flash_bwd_sm90", "flash_bwd_fp32")
EVERY = ("bwd_prologue", "bwd_sum_heads", "flash_bwd_sm90",
         "flash_bwd_dq_sm90", "flash_bwd_fp32")


def read(run):
    c = run.config
    H, KV, d_qk, d_v = counts.attention_dims(c)
    window = c.get("sliding_window") or 0

    def bounds(seqs):
        B, S = len(seqs), seqs[0]
        return [(c["num_hidden_layers"], counts.bound_s(
            counts.k2_backward_bytes(B, S, H, KV, d_qk, d_v=d_v),
            counts.k2_backward_ops(B, S, H, d_qk, True, window, d_v=d_v),
            run.peaks))]
    return readers.roofline_share(run, MAIN, EVERY, bounds)
