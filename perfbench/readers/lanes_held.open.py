"""Mean share of an engine's lanes held after admission (the
engine.admission spans), before the profiled sub-window."""
from perfbench import spans


def read(rec):
    return spans.lanes_held(rec)
