"""tokens_per_s (``.train``, ``.prefill``): the tokens of every train step
(microbatches x batch x sequence) or prompt the window completed, over the
window's seconds, from its start to the last synchronised result (host
clock)."""
from portbench.readers import tokens_per_s as read  # noqa: F401
