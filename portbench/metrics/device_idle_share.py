"""device_idle_share (``.train``, ``.prefill``): the share of the traced
stretch of steps or requests in which no operation ran on the device
(profiler trace)."""
from portbench.readers import idle_share as read  # noqa: F401
