"""flash_attention's share of its roofline in the profiled sub-window."""
from perfbench import layers


def read(rec):
    return layers.flash_attention_roofline(rec)
