"""accum_ms: the device ms a train step's kernels launched inside
``rt.train.accumulate`` (the fp32 accumulator's zeros and each
microbatch's add) take, the traced span calls' mean (device trace, by the
program's span)."""
from portbench import readers, trace


def read(run):
    return readers.span_ms(run, trace.feeds("accumulate"))
