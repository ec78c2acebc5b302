"""StarCoder2-3B — dense GQA + RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    citation="arXiv:2402.19173",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,          # GQA kv=2
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    gated_ffn=False,         # StarCoder2 uses a plain (non-gated) MLP
    pattern=(("attn", "dense"),),
    # StarCoder2 natively interleaves 4k sliding-window attention; we use the
    # window for the long_500k serving shape.
    long_context_window=4096,
)
