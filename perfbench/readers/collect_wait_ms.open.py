"""Mean milliseconds collect blocks on the step's device-to-host copy
(the engine.collect_wait span), before the profiled sub-window.  Unit
ms; lower is better.

Its hooks switch the port's tracer on and drain it (``spans.begin``,
``spans.collect``)."""
from perfbench import spans

begin, collect = spans.begin, spans.collect


def read(rec):
    return spans.collect_wait_ms(rec)
