"""Attention variants (PyTorch port of the reference's
``models/transformer/attention.py``): GQA with a KV cache or a
sliding-window ring cache (causal, or non-causal for Whisper's encoder;
M-RoPE's three position streams for Qwen2-VL), Whisper's cross
attention over the encoder's keys and values, and DeepSeek-V3's MLA
(multi-head latent attention) with its absorbed-matmul decode.

Full-sequence attention and cross attention (over a prompt, or one
decode token against the encoder's keys) go through
:func:`layers.attention` (K7 on the card): GQA at its head width, MLA
with q and k ``qk_nope_head_dim + qk_rope_head_dim`` wide (192 at
DeepSeek-V3's widths) and v ``v_head_dim`` (128).  One-token decode
keeps the reference's softmax over the whole cache in plain PyTorch (XLA
in the reference, not a Pallas kernel): GQA over per-head keys and
values, MLA in the latent space, its cache the normalized latent ``c``
and the rotary key ``kr`` (never per-head keys and values).  Decode
writes into the cache in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import layers as L

NEG_INF = L.NEG_INF


def init_gqa(cfg, gen, dtype, device):
    hd = cfg.resolved_head_dim
    p = {
        "wq": L.dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype, device),
        "wk": L.dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                           device),
        "wv": L.dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                           device),
        "wo": L.dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.num_heads * hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(cfg.num_kv_heads * hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(cfg.num_kv_heads * hd, dtype=dtype, device=device)
    return p


def _q(cfg, p, x):
    B, S, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return q.reshape(B, S, cfg.num_heads, cfg.resolved_head_dim)


def _kv(cfg, p, x):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(B, S, cfg.num_kv_heads, hd),
            v.reshape(B, S, cfg.num_kv_heads, hd))


def _qkv(cfg, p, x):
    return (_q(cfg, p, x),) + _kv(cfg, p, x)


def _rope_qk(cfg, q, k, positions):
    if cfg.pos_emb != "rope":
        return q, k
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary,
                     cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary,
                     cfg.mrope_sections)
    return q, k


def gqa_forward(cfg, p, x, positions, *, causal=True, window=0,
                return_kv=False):
    """Full-sequence attention (prefill; Whisper's encoder with
    ``causal=False``).  positions: (B, S), or (3, B, S) under M-RoPE."""
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions)
    out = L.attention(q, k, v, causal=causal, q_offset=0, window=window,
                      q_chunk=cfg.attn_q_chunk)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def gqa_decode(cfg, p, x, cache_k, cache_v, pos: int, *, window=0):
    """One-token decode.  x: (B, 1, D); ``pos``: the absolute position.

    cache_[kv]: (B, C, K, hd), C the capacity (full) or the window (ring
    buffer); the token's key and value are written into slot ``pos`` (or
    ``pos % C``) in place.  Under M-RoPE all three position streams take
    ``pos``, the slot index, as in the reference (so after an image
    prompt, whose M-RoPE positions run below its length, decode rotates
    at the slot, not at the last position + 1).  Returns (out, cache_k,
    cache_v)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(cfg, p, x)
    if cfg.pos_emb == "rope":
        pos_arr = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        if cfg.mrope_sections is not None:
            pos_arr = pos_arr.expand(3, B, 1)
        q, k = _rope_qk(cfg, q, k, pos_arr)

    C = cache_k.shape[1]
    slot = pos % C if window else pos
    if not 0 <= slot < C:
        raise IndexError(f"position {pos} outside a cache of {C} slots")
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    slots = torch.arange(C, device=x.device)
    if window:
        # ring buffer: slot s holds absolute position pos - ((pos - s) mod
        # C); valid iff that position has been written
        valid = pos - torch.remainder(pos - slots, C) >= 0
    else:
        valid = slots <= pos

    K = cfg.num_kv_heads
    G = cfg.num_heads // K
    qg = (q * (1.0 / np.sqrt(hd))).reshape(B, 1, K, G, hd)
    # the reference's masked softmax over the whole cache (plain XLA
    # there, no kernel), not layers.attention: see its plain version
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), cache_k.float())
    logits = logits.masked_fill(~valid[None, None, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, cache_v.float())
    out = out.reshape(B, 1, cfg.num_heads * hd).to(x.dtype) @ p["wo"]
    return out, cache_k, cache_v


def cross_attention(cfg, p, x, k, v):
    """Cross attention (Whisper's decoder): queries from ``x`` (B, S, D)
    over the encoder's keys and values (B, Se, K, hd; :func:`_kv` of the
    encoder output, which the reference computes beside a q it drops),
    non-causal, no rotary; K7 on the card for a prompt and for one decode
    token alike."""
    q = _q(cfg, p, x)
    o = L.attention(q, k, v, causal=False, q_offset=0)
    return o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]


# ===========================================================================
# MLA (DeepSeek-V3)
# ===========================================================================

def init_mla(cfg, gen, dtype, device):
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dc, dq = cfg.kv_lora_rank, cfg.q_lora_rank
    return {
        "wq_a": L.dense_init(gen, cfg.d_model, dq, dtype, device),
        "q_norm": torch.ones(dq, device=device),
        "wq_b": L.dense_init(gen, dq, H * (dn + dr), dtype, device),
        "wkv_a": L.dense_init(gen, cfg.d_model, dc + dr, dtype, device),
        "kv_norm": torch.ones(dc, device=device),
        "w_k_nope": L.normal(gen, (dc, H, dn), device, 1.0 / np.sqrt(dc),
                             dtype),
        "w_v": L.normal(gen, (dc, H, dv), device, 1.0 / np.sqrt(dc), dtype),
        "wo": L.dense_init(gen, H * dv, cfg.d_model, dtype, device),
    }


def _mla_q(cfg, p, x, positions):
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = L.rmsnorm(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(cfg, p, x, positions):
    """Latent path: (c_n the normalized latent (B, S, dc), k_rope
    (B, S, 1, dr))."""
    dc = cfg.kv_lora_rank
    ckr = x @ p["wkv_a"]
    c, k_rope = ckr[..., :dc], ckr[..., dc:]
    c_n = L.rmsnorm(c, p["kv_norm"])
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_n, k_rope


def mla_forward(cfg, p, x, positions, *, window=0, return_cache=False):
    """Prefill: the latent decompressed to per-head keys and values,
    then :func:`layers.attention` with q and k ``dn + dr`` wide and v
    ``dv``.  With ``return_cache``, also (c_n (B, S, dc), k_rope (B, S,
    dr)), the latent cache's rows."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dc = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_n, k_rope = _mla_latent(cfg, p, x, positions)

    # the reference's einsums "bsc,chn->bshn" and "bsc,chv->bshv", as
    # products with (dc, H * width) views: contiguous (B, S, H, width)
    k_nope = (c_n @ p["w_k_nope"].reshape(dc, H * dn)).reshape(B, S, H, dn)
    v = (c_n @ p["w_v"].reshape(dc, H * dv)).reshape(B, S, H, dv)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)

    out = L.attention(q, k, v, causal=True, q_offset=0, window=window,
                      q_chunk=cfg.attn_q_chunk)
    out = out.reshape(B, S, H * dv) @ p["wo"]
    if return_cache:
        return out, (c_n, k_rope[:, :, 0, :])
    return out


def mla_decode(cfg, p, x, cache_c, cache_kr, pos: int, *, window=0):
    """Absorbed-matmul decode: scores and values in the dc-wide latent
    space, per-head keys and values never built.  x: (B, 1, D); cache_c:
    (B, C, dc) normalized latents, cache_kr: (B, C, dr), the token's rows
    written into slot ``pos`` (or ``pos % C``) in place; a slot outside
    the cache raises ``IndexError``.  Returns (out, cache_c, cache_kr)."""
    B = x.shape[0]
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    pos_arr = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, pos_arr)          # (B,1,H,dn/dr)
    c_n, k_rope = _mla_latent(cfg, p, x, pos_arr)        # (B,1,dc), (B,1,1,dr)

    C = cache_c.shape[1]
    slot = pos % C if window else pos
    if not 0 <= slot < C:
        raise IndexError(f"position {pos} outside a cache of {C} slots")
    cache_c[:, slot] = c_n[:, 0].to(cache_c.dtype)
    cache_kr[:, slot] = k_rope[:, 0, 0].to(cache_kr.dtype)

    slots = torch.arange(C, device=x.device)
    if window:
        valid = pos - torch.remainder(pos - slots, C) >= 0
    else:
        valid = slots <= pos

    # absorb W_k_nope into the query
    q_abs = torch.einsum("bqhn,chn->bqhc", q_nope, p["w_k_nope"])
    scores = (torch.einsum("bqhc,bsc->bhqs", q_abs.float(), cache_c.float())
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             cache_kr.float()))
    scores = scores / float(np.sqrt(dn + dr))
    scores = scores.masked_fill(~valid[None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bsc->bqhc", w, cache_c.float())
    out = torch.einsum("bqhc,chv->bqhv", ctx.to(x.dtype), p["w_v"])
    out = out.reshape(B, 1, H * dv) @ p["wo"]
    return out, cache_c, cache_kr
