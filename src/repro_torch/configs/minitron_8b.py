"""Minitron-8B — width/depth-pruned Nemotron-4. [arXiv:2407.14679]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    citation="arXiv:2407.14679",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    gated_ffn=False,         # Nemotron uses squared-ReLU, non-gated MLP
    pattern=(("attn", "dense"),),
    long_context_window=8192,
)
