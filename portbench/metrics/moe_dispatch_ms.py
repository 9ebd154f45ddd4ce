"""moe_dispatch_ms (``.train``, ``.prefill``): the device ms of the MoE
block's dispatch, a step's or a request's mean over the traced span calls:
the kernels launched inside ``rt.moe.route``, ``rt.moe.pack`` and
``rt.moe.combine``, and inside ``rt.moe.bwd`` but not its
``rt.moe.experts.bwd`` (device trace, by the program's spans)."""
from portbench import readers, trace


def read(run):
    return readers.span_ms(run, trace.feeds("moe_dispatch"))
