"""k2_bwd_roofline: K2's backward share of its roofline (2.5x the
forward's operations: five products against two), over the device time of
its kernels (prologue, dK/dV, dQ, the GQA sum)."""
from portbench import counts, readers

MAIN = ("flash_bwd_sm90", "flash_bwd_fp32")
EVERY = ("bwd_prologue", "bwd_sum_heads", "flash_bwd_sm90",
         "flash_bwd_dq_sm90", "flash_bwd_fp32")


def read(run):
    c = run.config
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or c["hidden_size"] // H
    window = c.get("sliding_window") or 0

    def bound(seqs):
        B, S = len(seqs), seqs[0]
        return counts.bound_s(counts.k2_backward_bytes(B, S, H, KV, hd),
                              counts.k2_backward_ops(B, S, H, hd, True, window),
                              run.peaks)
    return readers.roofline_share(run, MAIN, EVERY, c["num_hidden_layers"],
                                  bound)
