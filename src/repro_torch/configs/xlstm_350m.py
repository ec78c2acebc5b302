"""xLSTM-350M — alternating sLSTM + mLSTM blocks. [arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own up/down projections (ffn="none").
Fully recurrent -> sub-quadratic decode, long_500k in-family.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    citation="arXiv:2405.04517",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    # xLSTM[7:1]-style interleave: mostly mLSTM with periodic sLSTM blocks.
    pattern=(("mlstm", "none"), ("mlstm", "none"), ("mlstm", "none"),
             ("slstm", "none")),
)
