"""Share of the prefill chunks' tokens that are prompt tokens (the
engine.prefill_chunk spans' tokens and padded), before the profiled
sub-window.  Unit %; higher is better (less padding computed).

Its hooks switch the port's tracer on and drain it (``spans.begin``,
``spans.collect``)."""
from perfbench import spans

begin, collect = spans.begin, spans.collect


def read(rec):
    return spans.chunk_fill(rec)
