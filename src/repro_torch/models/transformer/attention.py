"""GQA attention with a KV cache or a sliding-window ring cache (PyTorch
port of the reference's ``models/transformer/attention.py:19-117``).

Full-sequence attention goes through :func:`layers.attention` (K7 on
the card).  One-token decode keeps the reference's masked softmax over
the whole cache in plain PyTorch (XLA in the reference, not a Pallas
kernel), and writes the new key and value into the cache in place.
MLA (DeepSeek-V3) waits with the ``mla_moe`` family.
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


def _qkv(cfg, p, x):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    return q, k, v


def _rope_qk(cfg, q, k, positions):
    if cfg.pos_emb != "rope":
        return q, k
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary,
                     cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary,
                     cfg.mrope_sections)
    return q, k


def gqa_forward(cfg, p, x, positions, *, window=0, return_kv=False):
    """Full-sequence causal attention (prefill).  positions: (B, S)."""
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions)
    out = L.attention(q, k, v, causal=True, q_offset=0, window=window,
                      q_chunk=cfg.attn_q_chunk)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def gqa_decode(cfg, p, x, cache_k, cache_v, pos: int, *, window=0):
    """One-token decode.  x: (B, 1, D); ``pos``: the absolute position.

    cache_[kv]: (B, C, K, hd), C the capacity (full) or the window (ring
    buffer); the token's key and value are written into slot ``pos`` (or
    ``pos % C``) in place.  Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(cfg, p, x)
    if cfg.pos_emb == "rope":
        pos_arr = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
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
