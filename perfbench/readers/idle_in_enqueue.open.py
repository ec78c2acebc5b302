"""Share of the profiled sub-window with the device idle under the port's
rt:engine.prefill_chunk or rt:engine.decode_round range."""
from perfbench import spans


def read(rec):
    return spans.idle_in_enqueue(rec)
