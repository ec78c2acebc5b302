"""Share of the profiled sub-window with no device operation running."""
from perfbench import layers


def read(rec):
    return layers.idle_share(rec)
