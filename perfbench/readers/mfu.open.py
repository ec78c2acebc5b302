"""Model FLOPs of the tokens computed over the stepping seconds, against
the bf16 peak."""
from perfbench import layers


def read(rec):
    return layers.mfu(rec)
