"""paged_flash_decode_window's share of its roofline in the profiled
sub-window: the K/V bytes of the positions inside each lane's window at
the HBM rate over its split and merge kernels' time.  Unit %; higher is
better.

Its hooks are the mellum2 readers' shared ones (``moe_window_layers``)."""
from perfbench import moe_window_layers

prepare = moe_window_layers.prepare
begin, collect = moe_window_layers.begin, moe_window_layers.collect


def read(rec):
    return moe_window_layers.window_decode_roofline(rec)
