"""GLM-4-9B [hf:THUDM/glm-4-9b] — dense decoder, partial (50%) rotary,
extreme GQA (kv=2), QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    citation="hf:THUDM/glm-4-9b",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    head_dim=128,
    qkv_bias=True,
    partial_rotary=0.5,
)
