"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

The SigLIP/CLIP vision tower is a STUB: ``input_specs`` provides precomputed
patch embeddings of shape (batch, patches, vision_dim).  The multimodal
projector (2-layer MLP) and the Mistral decoder are implemented for real;
anyres tiling determines ``vision_patches`` (here the 576-patch base tile).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,          # GQA kv=8 (Mistral)
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    gated_ffn=True,          # SwiGLU
    vision_patches=576,      # 24x24 base-resolution tile (anyres base)
    vision_dim=1024,         # CLIP ViT-L/14 feature width
    pattern=(("attn", "dense"),),
    long_context_window=8192,
)
