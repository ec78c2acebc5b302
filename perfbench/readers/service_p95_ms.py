"""The 95th percentile of the arrival-to-last-token milliseconds, over
every request due in the window."""
from perfbench import layers


def read(rec):
    return layers.service_p95_ms(rec)
