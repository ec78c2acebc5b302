"""Mean milliseconds of the LAD-TS decision inside EdgeCluster.submit
(the scheduler.select span), before the profiled sub-window.  Unit ms;
lower is better.

Its hooks switch the port's tracer on and drain it (``spans.begin``,
``spans.collect``)."""
from perfbench import spans

begin, collect = spans.begin, spans.collect


def read(rec):
    return spans.select_ms(rec)
