"""Mean milliseconds of one EdgeCluster.step (the port's cluster.step
span), before the profiled sub-window.  Unit ms; lower is better.

Its hooks switch the port's tracer on and drain it (``spans.begin``,
``spans.collect``)."""
from perfbench import spans

begin, collect = spans.begin, spans.collect


def read(rec):
    return spans.step_ms(rec)
