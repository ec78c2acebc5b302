"""The largest engine's share of the requests placed."""
from perfbench import layers


def read(rec):
    return layers.engine_skew(rec)
