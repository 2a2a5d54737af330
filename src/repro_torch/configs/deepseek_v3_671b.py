"""DeepSeek-V3 671B [arXiv:2412.19437].

MLA (multi-head latent attention) + MoE with 1 shared + 256 routed experts
(top-8), first 3 layers dense. The MTP (multi-token-prediction) auxiliary
head is an optional training add-on in the paper and is omitted from the
step functions, as the reference omits it.  The numbers are the
reference's config; the published router (sigmoid gates with a bias
term, node-limited routing, a routed scaling factor) and YaRN's RoPE
scaling are not modelled there, nor here: both route by softmax top-k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    citation="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,  # MLA: effectively MHA over latent-decompressed KV
    d_ff=18432,        # dense-layer FFN width
    vocab_size=129280,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
)
