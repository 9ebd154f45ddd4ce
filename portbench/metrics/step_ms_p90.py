"""step_ms_p90 (``.train``, ``.prefill``): the 90th percentile of the
window's train steps or requests, each from its call to its synchronised
result (host clock)."""
from portbench.readers import p90_ms as read  # noqa: F401
