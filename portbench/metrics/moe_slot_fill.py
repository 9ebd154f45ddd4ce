"""moe_slot_fill (``.train``, ``.prefill``): the share of the expert
buffer's rows that hold a routed row, over the traced span calls: the
program's counters ``moe.rows_kept`` over ``moe.slots``."""
from portbench import readers


def read(run):
    return readers.counter_share(run, "moe.rows_kept", "moe.slots")
