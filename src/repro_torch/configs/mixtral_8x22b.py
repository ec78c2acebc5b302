"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    citation="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    gated_ffn=True,          # SwiGLU experts
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    pattern=(("attn", "moe"),),
    microbatches=16,   # d_model=6144: halve the remat residual stack
    # decode shapes: never re-gather expert weights per token — gather the
    # tiny token batch instead (weights-stationary serving MoE, §Perf H1:
    # 15x less collective traffic on decode_32k)
    moe_stationary_serve=True,
    attn_chunk=512,    # shrink transient attention score tiles (§Perf H3)
    sliding_window=4096,     # native SWA -> long_500k is in-family
)
