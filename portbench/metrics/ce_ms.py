"""ce_ms: the device ms a train step's kernels launched inside
``rt.train.ce`` and ``rt.train.ce.bwd`` (the chunked CE's forward, its
recompute and backward) take, the traced span calls' mean (device trace,
by the program's spans)."""
from portbench import readers, trace


def read(run):
    return readers.span_ms(run, trace.feeds("chunked_ce"))
