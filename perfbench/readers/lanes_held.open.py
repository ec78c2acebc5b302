"""Mean share of an engine's lanes held after admission (the
engine.admission spans), before the profiled sub-window.  Unit %;
higher is better (more requests batched a step).

Its hooks switch the port's tracer on and drain it (``spans.begin``,
``spans.collect``)."""
from perfbench import spans

begin, collect = spans.begin, spans.collect


def read(rec):
    return spans.lanes_held(rec)
