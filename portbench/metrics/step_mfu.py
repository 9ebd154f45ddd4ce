"""step_mfu (``.train``, ``.prefill``): the model FLOPs of the window's
train steps or prefills (``counts.step_flops``: a training step's 3x the
forward's) over the window's seconds, as a share of the bf16 peak (host
clock)."""
from portbench.readers import mfu as read  # noqa: F401
