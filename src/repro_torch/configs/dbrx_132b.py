"""DBRX-132B — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    citation="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    gated_ffn=True,
    moe=MoEConfig(num_experts=16, top_k=4, capacity_factor=1.25),
    pattern=(("attn", "moe"),),
    microbatches=16,   # d_model=6144: halve the remat residual stack
    # decode shapes: never re-gather expert weights per token — gather the
    # tiny token batch instead (weights-stationary serving MoE, §Perf H1:
    # 15x less collective traffic on decode_32k)
    moe_stationary_serve=True,
    # full attention: long_500k served via the beyond-paper SW variant
    long_context_window=8192,
)
