"""Qwen2.5-14B [hf:Qwen/Qwen2.5-14B] — dense decoder, GQA, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    citation="hf:Qwen/Qwen2.5-0.5B (family card, 14B variant)",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
