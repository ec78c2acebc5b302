"""StarCoder2-7B — dense GQA + RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    citation="arXiv:2402.19173",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,          # GQA kv=4
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    gated_ffn=False,
    pattern=(("attn", "dense"),),
    long_context_window=4096,
)
