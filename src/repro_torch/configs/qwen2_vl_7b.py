"""Qwen2-VL-7B language backbone [arXiv:2409.12191].

The ViT vision encoder and its projector are stubbed, as in the
reference: the model takes precomputed patch and text embeddings (B, S,
d_model) and M-RoPE position ids (3, B, S), the temporal, height and
width streams.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    citation="arXiv:2409.12191",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # sums to head_dim // 2
)
