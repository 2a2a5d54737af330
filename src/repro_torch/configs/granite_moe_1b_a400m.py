"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] —
MoE with 32 experts, top-8, every layer; GQA 16H/kv8.
vocab 49155 padded to 49408 by ``padded_vocab`` (as the reference pads
it).  The numbers are the reference's config; Hugging Face's embedding,
attention, residual and logit multipliers are not modelled there, nor
here."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,          # dense path unused; experts use moe_d_ff
    vocab_size=49155,
    head_dim=64,
    num_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    tie_embeddings=True,
)
