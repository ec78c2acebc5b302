"""Qwen2-1.5B — dense GQA with QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    citation="arXiv:2407.10671",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,          # GQA kv=2
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,           # Qwen2 signature: bias on QKV projections
    gated_ffn=True,
    tie_embeddings=True,     # Qwen2-1.5B ties embed/lm_head
    pattern=(("attn", "dense"),),
    long_context_window=8192,
)
