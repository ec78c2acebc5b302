"""Mean milliseconds a request waited in its engine's queue
(Request.queue_s)."""
from perfbench import layers


def read(rec):
    return layers.queue_ms(rec)
