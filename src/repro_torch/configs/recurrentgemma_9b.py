"""RecurrentGemma-9B — Griffin hybrid: RG-LRU recurrent blocks interleaved
with local (windowed) attention at a 1:2 attention:recurrent ratio.
[arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    citation="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,          # MQA kv=1
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    gated_ffn=True,
    rg_lru_dim=4096,
    local_window=2048,       # local attention window
    # (recurrent, recurrent, local-attn) repeating — 1:2 attn:recurrent
    pattern=(("rglru", "dense"), ("rglru", "dense"), ("attn", "dense")),
)
