"""Mean milliseconds of one EdgeCluster.step (the port's cluster.step
span), before the profiled sub-window."""
from perfbench import spans


def read(rec):
    return spans.step_ms(rec)
