"""Whisper-tiny [arXiv:2212.04356] — encoder-decoder, 4 + 4 layers.

The mel-spectrogram and conv frontend are stubbed, as in the reference:
the encoder takes precomputed frame embeddings (B, S, d_model).
Whisper uses plain (non-gated) GELU MLPs, LayerNorm and learned absolute
positions (``enc_pos``, ``dec_pos``).  vocab 51865 padded to 51968.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    citation="arXiv:2212.04356",
    num_layers=4,          # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    mlp_gated=False,
    pos_emb="learned",
)
