"""The dropless MoE's grouped expert products' share of their roofline
in the profiled sub-window: routed-row FLOPs at the bf16 peak or the
touched experts' weights at the HBM rate, whichever is longer, over the
grouped GEMM kernels' time.  Unit %; higher is better.

Its hooks (shared with the other two mellum2 readers) copy the port's
routed-rows counter after each step call and record the windowed
decode's calls (``moe_window_layers``)."""
from perfbench import moe_window_layers

prepare = moe_window_layers.prepare
begin, collect = moe_window_layers.begin, moe_window_layers.collect


def read(rec):
    return moe_window_layers.expert_gemm_roofline(rec)
