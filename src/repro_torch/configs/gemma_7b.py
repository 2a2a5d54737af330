"""Gemma-7B [arXiv:2403.08295] — GeGLU, head_dim=256, tied embeddings,
embeddings scaled by sqrt(d_model). (MQA is the 2b variant; 7b is MHA.)"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    citation="arXiv:2403.08295",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)
