"""Host milliseconds of one call to the paged decode step callable."""
from perfbench import layers


def read(rec):
    return layers.host_ms(rec["decode_calls"])
