"""The busiest expert's routed rows over the mean expert's, per layer and
step call of the window, weighted by the call's rows, from the port's
routed-rows counter.  Unit ratio; lower is better (1 is an even load).

Its hooks are the mellum2 readers' shared ones (``moe_window_layers``)."""
from perfbench import moe_window_layers

prepare = moe_window_layers.prepare
begin, collect = moe_window_layers.begin, moe_window_layers.collect


def read(rec):
    return moe_window_layers.expert_skew(rec)
