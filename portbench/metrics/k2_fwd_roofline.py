"""k2_fwd_roofline (``.train``, ``.prefill``): K2 flash attention's forward
share of its roofline (the larger of the causal pairs' operations at the
bf16 peak and the bytes at the memory peak, a launch, over the forward
kernel's device time)."""
from portbench import counts, readers

FORWARD = ("flash_fwd_sm90", "flash_fwd_fp32")


def read(run):
    c = run.config
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or c["hidden_size"] // H
    window = c.get("sliding_window") or 0
    train = run.mix["driver"] == "train"

    def bound(seqs):
        B, S = len(seqs), seqs[0]
        return counts.bound_s(counts.k2_forward_bytes(B, S, H, KV, hd, train),
                              counts.k2_forward_ops(B, S, H, hd, True, window),
                              run.peaks)
    return readers.roofline_share(run, FORWARD, FORWARD,
                                  c["num_hidden_layers"], bound)
