"""Host milliseconds of one EdgeCluster.submit (LAD-TS placement)."""
from perfbench import layers


def read(rec):
    return layers.place_ms(rec)
