"""Config system of the port's transformer zoo (a copy of the reference's
``configs/base.py``; nothing of the reference is imported).

Every architecture has a module ``repro_torch/configs/<id>.py`` exposing
``CONFIG`` (a :class:`ModelConfig` with the published numbers); every
config of the reference is ported.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

ARCH_IDS = (
    "qwen2_vl_7b",
    "deepseek_v3_671b",
    "mamba2_780m",
    "qwen2_5_14b",
    "whisper_tiny",
    "zamba2_2_7b",
    "phi3_mini_3_8b",
    "glm4_9b",
    "gemma_7b",
    "granite_moe_1b_a400m",
)

# public-pool ids (with dashes) -> module names
ARCH_ALIASES = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mamba2-780m": "mamba2_780m",
    "qwen2.5-14b": "qwen2_5_14b",
    "whisper-tiny": "whisper_tiny",
    "zamba2-2.7b": "zamba2_2_7b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "glm4-9b": "glm4_9b",
    "gemma-7b": "gemma_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
}

#: the family of every architecture, ported or not
ARCH_FAMILIES = {
    "qwen2_vl_7b": "vlm",
    "deepseek_v3_671b": "mla_moe",
    "mamba2_780m": "ssm",
    "qwen2_5_14b": "dense",
    "whisper_tiny": "encdec",
    "zamba2_2_7b": "hybrid",
    "phi3_mini_3_8b": "dense",
    "glm4_9b": "dense",
    "gemma_7b": "dense",
    "granite_moe_1b_a400m": "moe",
}

#: the configs the port carries (``repro_torch/configs/<id>.py``): all
PORTED_CONFIGS = ("phi3_mini_3_8b", "mamba2_780m", "qwen2_5_14b",
                  "gemma_7b", "glm4_9b", "zamba2_2_7b",
                  "granite_moe_1b_a400m", "deepseek_v3_671b",
                  "whisper_tiny", "qwen2_vl_7b")
#: the families the port's model runs
PORTED_FAMILIES = ("dense", "ssm", "hybrid", "moe", "mla_moe", "encdec",
                   "vlm")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.

    ``family`` selects the forward function:
      dense | moe | mla_moe | ssm | hybrid | encdec | vlm
    The fields are the reference's that the port reads; the reference's
    lowering and survey switches (``scan_unroll``,
    ``parallelism``, ``sync_mode``, ``coordination``) have nothing to
    switch on one card.
    """

    name: str
    family: str
    citation: str

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None           # defaults to d_model // num_heads
    qkv_bias: bool = False                   # qwen-style attention bias
    tie_embeddings: bool = False
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    act: str = "silu"                        # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10_000.0
    partial_rotary: float = 1.0              # glm4 uses 0.5
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    mlp_gated: bool = True                   # SwiGLU/GeGLU vs plain 2-layer MLP
    pos_emb: str = "rope"                    # rope | learned (whisper)
    embed_scale: bool = False                # gemma: scale embeds by sqrt(d)

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                        # per-expert hidden dim
    first_dense_layers: int = 0              # deepseek-v3: first 3 layers dense
    moe_capacity_factor: float = 1.25        # GShard dropping capacity
    moe_impl: str = "gshard"                 # gshard | ep (expert parallel)

    # --- MLA (deepseek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 64
    attn_every: int = 0                      # zamba2: shared block period

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0

    # --- serving ---
    sliding_window: int = 0                  # >0: ring-buffer KV cache variant

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = ""                    # KV cache dtype override

    # query-block size of the plain chunked attention (the card runs the
    # flash-attention kernel, which tiles queries itself)
    attn_q_chunk: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the reference pads it."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        kw = dict(
            num_layers=2,
            d_model=256,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=512,
            vocab_size=512,
            head_dim=64,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.num_experts:
            kw.update(num_experts=4, experts_per_token=2, moe_d_ff=128,
                      first_dense_layers=min(self.first_dense_layers, 1),
                      moe_capacity_factor=8.0)  # drop-free at smoke scale
        if self.q_lora_rank or self.kv_lora_rank:
            kw.update(q_lora_rank=64, kv_lora_rank=32, qk_rope_head_dim=16,
                      qk_nope_head_dim=32, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
        if self.attn_every:
            kw.update(attn_every=1)
        if self.encoder_layers:
            kw.update(encoder_layers=2)
        if self.mrope_sections:
            kw.update(mrope_sections=(8, 12, 12))  # sums to head_dim//2 = 32
        if self.sliding_window:
            kw.update(sliding_window=64)
        return self.replace(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def arch_module(arch: str) -> str:
    """The module name of ``arch`` (an id or its dashed alias); raises
    ``KeyError`` for an unknown one."""
    mod_name = ARCH_ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch!r}; known: "
                       f"{sorted(ARCH_ALIASES)}")
    return mod_name


def get_config(arch: str) -> ModelConfig:
    """The config of ``arch`` (an id or its dashed alias); an unknown one
    raises ``KeyError``."""
    mod = importlib.import_module(f"repro_torch.configs.{arch_module(arch)}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]
