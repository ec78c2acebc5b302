"""Share of the prefill chunks' tokens that are prompt tokens (the
engine.prefill_chunk spans' tokens and padded), before the profiled
sub-window."""
from perfbench import spans


def read(rec):
    return spans.chunk_fill(rec)
