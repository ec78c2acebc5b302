"""Host milliseconds of one call to the paged prefill step callable."""
from perfbench import layers


def read(rec):
    return layers.host_ms(rec["prefill_calls"])
