"""Mean milliseconds of the LAD-TS decision inside EdgeCluster.submit
(the scheduler.select span), before the profiled sub-window."""
from perfbench import spans


def read(rec):
    return spans.select_ms(rec)
