"""program_idle_share (``.train``, ``.prefill``): the share of the traced
span calls' wall in which the host was inside ``rt.train.step`` or
``rt.serve.prefill``, not in the profiler's own events, and no operation
ran on the device: the idle the program's host path causes (device trace,
by the program's spans)."""
from portbench.readers import program_idle_share as read  # noqa: F401
