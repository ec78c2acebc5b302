"""Mellum2-12B-A2.5B — JetBrains' code-completion MoE: 64 experts of
width 896, top-8 with renormalised gates and no shared expert, in every
layer; three sliding-window layers (1024) to one full-attention layer,
default RoPE on the sliding layers and yarn on the full ones.
[https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct,
config.json]

The port's own config: the reference has no such model.  Its experts are
dropless (``capacity_factor`` None), as the published model computes
every routed token.  ``intermediate_size`` 7168 is unused, since every
``mlp_layer_types`` entry is ``sparse``; ``d_ff`` is the expert width.
Departures: the multi-token-prediction head the family is described with
is not in the config and is not used by greedy serving; no q/k norm is
named, so none is applied; the router's weight is kept in f32 (the
port's MoE routes in f32, softmax over all 64 experts, then top-8).
"""
from repro_torch.configs.base import (AttentionKind, LayerTypesConfig,
                                      MoEConfig, RopeSpec)

ROPE_THETA = 500_000.0

CONFIG = LayerTypesConfig(
    name="mellum2-12b",
    family="moe",
    citation="https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct",
    num_layers=28,
    d_model=2304,
    num_heads=32,
    num_kv_heads=4,          # GQA kv=4
    head_dim=128,
    d_ff=896,                # moe_intermediate_size
    vocab_size=98304,
    gated_ffn=True,          # SiLU-gated experts
    moe=MoEConfig(num_experts=64, top_k=8, capacity_factor=None),
    pattern=(("attn", "moe"),),
    rope_theta=ROPE_THETA,
    norm_eps=1e-6,
    tie_embeddings=False,
    scan_layers=False,
    layer_types=("sliding_attention",) * 3 + ("full_attention",),
    attention_kinds=(
        ("sliding_attention",
         AttentionKind(window=1024, rope=RopeSpec(theta=ROPE_THETA))),
        ("full_attention",
         AttentionKind(rope=RopeSpec(theta=ROPE_THETA, kind="yarn",
                                     factor=16.0,
                                     original_max_position=8192,
                                     beta_fast=32.0, beta_slow=1.0,
                                     attention_factor=1.2772588722239782))),
    ),
)
