"""Zamba2-2.7B [arXiv:2411.15242] — hybrid: Mamba2 backbone + shared
attention block applied every 6 layers (9 applications over 54 layers,
same weights each time).

Simplification vs the released model (as in the reference's config): the
shared block operates on the d_model-wide stream (the released model
concatenates the original embedding, doubling the block width) and LoRA
adapters on the shared block are omitted.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    citation="arXiv:2411.15242",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    attn_every=6,
)
