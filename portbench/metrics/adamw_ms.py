"""adamw_ms: the device ms a train step's kernels launched inside
``rt.adamw.update`` (the clip norm and every leaf's update) take, the
traced span calls' mean (device trace, by the program's span)."""
from portbench import readers, trace


def read(run):
    return readers.span_ms(run, trace.feeds("adamw"))
