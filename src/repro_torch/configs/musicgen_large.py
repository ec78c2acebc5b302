"""MusicGen-Large — decoder-only over EnCodec tokens. [arXiv:2306.05284]

The EnCodec conv codec itself is a STUB: ``input_specs`` provides the 4
codebook token streams directly.  The decoder sums the per-codebook
embeddings (delay-pattern handling lives in the data pipeline) and has one
LM head per codebook — those parts are implemented for real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    citation="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,         # MHA (kv=32)
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    num_codebooks=4,
    gated_ffn=False,         # MusicGen uses plain ReLU MLPs
    use_rope=False,          # sinusoidal positions, not rotary
    pattern=(("attn", "dense"),),
    # MHA (kv=32) makes the decode_32k cache the largest per-token state of
    # any assigned arch (19.8 GB/chip in bf16 — over the 16 GB HBM budget);
    # int8 cache storage brings it to 3.8 GB at ~1% logit error (§Perf H2).
    kv_cache_dtype="int8",
    long_context_window=8192,
)
