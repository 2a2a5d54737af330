"""Mamba2-780m [arXiv:2405.21060] — SSD (state-space duality), attention-free.

vocab 50280 padded to 50432 (a multiple of 256, as the reference pads it).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    citation="arXiv:2405.21060",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
