"""Share of the profiled sub-window with the device idle under the port's
rt:engine.prefill_chunk or rt:engine.decode_round range.  Unit %; lower
is better.

Its hooks switch the port's tracer on and drain it (``spans.begin``,
``spans.collect``)."""
from perfbench import spans

begin, collect = spans.begin, spans.collect


def read(rec):
    return spans.idle_in_enqueue(rec)
