"""paged_flash_decode's share of its roofline in the profiled sub-window."""
from perfbench import layers


def read(rec):
    return layers.paged_decode_roofline(rec)
