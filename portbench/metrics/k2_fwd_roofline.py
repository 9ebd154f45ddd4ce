"""k2_fwd_roofline (``.train``, ``.prefill``): K2 flash attention's forward
share of its roofline (the larger of the causal pairs' operations at the
bf16 peak and the bytes at the memory peak, a launch, at the heads and
head sizes of ``counts.attention_dims``, over the forward kernel's device
time)."""
from portbench import counts, readers

FORWARD = ("flash_fwd_sm90", "flash_fwd_fp32")


def read(run):
    c = run.config
    H, KV, d_qk, d_v = counts.attention_dims(c)
    window = c.get("sliding_window") or 0
    train = run.mix["driver"] == "train"

    def bounds(seqs):
        B, S = len(seqs), seqs[0]
        return [(c["num_hidden_layers"], counts.bound_s(
            counts.k2_forward_bytes(B, S, H, KV, d_qk, train, d_v=d_v),
            counts.k2_forward_ops(B, S, H, d_qk, True, window, d_v=d_v),
            run.peaks))]
    return readers.roofline_share(run, FORWARD, FORWARD, bounds)
