"""Mean milliseconds collect blocks on the step's device-to-host copy
(the engine.collect_wait span), before the profiled sub-window."""
from perfbench import spans


def read(rec):
    return spans.collect_wait_ms(rec)
