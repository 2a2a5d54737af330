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

from repro_torch.launch import sharding as shd
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


def _heads(t, n, hd):
    """(B, S, n * hd) -> (B, S, n, hd).  Under sharding rules a projection
    whose heads do not divide over ``model`` is all-gathered there first
    (:func:`~repro_torch.launch.sharding.whole_heads`): GQA's K and V
    with fewer KV heads than ``model`` (GLM-4-9B's 2, Qwen2-VL-7B's 4,
    Qwen2.5-14B's 8 against 16) cost one all-gather of B_loc * S * K *
    hd elements each a layer (and its reduce-scatter in the backward),
    and every ``model`` rank then holds all K heads; the queries of
    Qwen2.5-14B (40 heads), Qwen2-VL-7B (28) and Whisper (6) likewise."""
    t = shd.whole_heads(t, n)
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def _merge(o):
    """(B, S, H, hd) -> (B, S, H * hd), the output projection's input:
    under sharding rules split over ``model`` on its last dim (the
    projection's contraction), explicitly, so that its gradient is
    gathered before the heads split again
    (:func:`~repro_torch.launch.sharding.shard_last`)."""
    return shd.shard_last(o.reshape(o.shape[0], o.shape[1], -1))


def _q(cfg, p, x):
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return _heads(q, cfg.num_heads, cfg.resolved_head_dim)


def _kv(cfg, p, x):
    hd = cfg.resolved_head_dim
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return (_heads(k, cfg.num_kv_heads, hd), _heads(v, cfg.num_kv_heads, hd))


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
    x = shd.gather_seq(x)
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions)
    out = L.attention(q, k, v, causal=causal, q_offset=0, window=window,
                      q_chunk=cfg.attn_q_chunk)
    out = shd.scatter_seq(_merge(out) @ p["wo"])
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
    at the slot, not at the last position + 1).  Under sharding rules the
    cache is split along its sequence: the slot's owner writes it, and
    the softmax runs per shard (:func:`cache_attention`).  Returns (out,
    cache_k, cache_v)."""
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
    shd.write_slot(cache_k, slot, k[:, 0])
    shd.write_slot(cache_v, slot, v[:, 0])

    K = cfg.num_kv_heads
    G = cfg.num_heads // K
    qs = q * (1.0 / np.sqrt(hd))
    rules = shd.sharded(cache_k)
    if rules is not None:
        # every rank of the cache's split takes all the query heads
        qs = qs.redistribute(cache_k.device_mesh,
                             shd.row_placements(cache_k))
    out = cache_attention(rules, qs.reshape(B, 1, K, G, hd), cache_k, cache_v,
                          lambda off, n, dev: _valid(pos, window, C, off, n,
                                                     dev))
    out = _merge(out.reshape(B, 1, cfg.num_heads, hd).to(x.dtype))
    return out @ p["wo"], cache_k, cache_v


def _valid(pos, window, C, off, n, device=None):
    """Which of the cache slots ``off .. off + n - 1`` hold a position at
    or before ``pos``: in a ring buffer (``window``) slot s holds absolute
    position pos - ((pos - s) mod C), valid iff that position has been
    written; else slots up to ``pos``."""
    slots = torch.arange(off, off + n, device=device)
    if window:
        return pos - torch.remainder(pos - slots, C) >= 0
    return slots <= pos


def cache_attention(rules, qg, cache_k, cache_v, valid=None):
    """The decode step's masked softmax over the whole cache (``qg`` (B,
    1, K, G, hd), already scaled; ``cache_[kv]`` (B, C, K, hd)) in
    float32: the reference's (plain XLA there, no kernel), not
    :func:`layers.attention`.  ``valid(offset, n, device)`` masks the
    slots ``offset .. offset + n - 1`` (``None``: every slot).  With
    sharding rules (``rules`` not ``None``) the cache is split along its
    sequence: each rank takes its slots, combined as a sharded softmax
    (:func:`~repro_torch.launch.sharding.split_softmax`).  Returns (B, 1,
    K, G, hd) float32 (under rules, with the cache's row placement)."""
    def scores(ql, kl, vl, off):
        lg = torch.einsum("bqkgh,bskh->bkgqs", ql.float(), kl.float())
        if valid is None:
            return lg
        ok = valid(off, kl.shape[1], lg.device)
        return lg.masked_fill(~ok[None, None, None, None, :], NEG_INF)

    def values(w, kl, vl):
        return torch.einsum("bkgqs,bskh->bqkgh", w, vl.float())

    if rules is None:
        w = torch.softmax(scores(qg, cache_k, cache_v, 0), dim=-1)
        return values(w, cache_k, cache_v)
    row = shd.row_placements(cache_k)
    se, acc = shd.split_softmax(rules, scores, values, [qg],
                                [cache_k, cache_v], [row])
    return acc / se.permute(0, 3, 1, 2)[..., None]


def cross_attention(cfg, p, x, k, v):
    """Cross attention (Whisper's decoder): queries from ``x`` (B, S, D)
    over the encoder's keys and values (B, Se, K, hd; :func:`_kv` of the
    encoder output, which the reference computes beside a q it drops),
    non-causal, no rotary; K7 on the card for a prompt and for one decode
    token alike."""
    x = shd.gather_seq(x)
    q = _q(cfg, p, x)
    rules = shd.sharded(k)
    if rules is not None and x.shape[1] == 1:
        # one decode token over the cross cache, split along its sequence
        B, _, H, hd = q.shape
        qs = (q * (1.0 / np.sqrt(hd))).redistribute(
            k.device_mesh, shd.row_placements(k))
        o = cache_attention(rules, qs.reshape(B, 1, k.shape[2], -1, hd), k,
                            v).reshape(B, 1, H, hd)
        return shd.scatter_seq(_merge(o.to(x.dtype)) @ p["wo"])
    o = L.attention(q, k, v, causal=False, q_offset=0)
    return shd.scatter_seq(_merge(o) @ p["wo"])


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
    x = shd.gather_seq(x)
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
    out = shd.scatter_seq(_merge(out) @ p["wo"])
    if return_cache:
        return out, (c_n, k_rope[:, :, 0, :])
    return out


def _mla_cache_attention(rules, cfg, q_abs, q_rope, cache_c, cache_kr, pos,
                         window):
    """:func:`mla_decode`'s masked softmax over the latent cache in
    float32, the reference's.  With sharding rules (``rules`` not
    ``None``) the cache is split along its sequence: each rank takes its
    slots, combined as a sharded softmax
    (:func:`~repro_torch.launch.sharding.split_softmax`).  Returns the
    context (B, 1, H, dc) float32."""
    C = cache_c.shape[1]
    scale = float(np.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))

    def scores(qa, qr, cl, krl, off):
        s = (torch.einsum("bqhc,bsc->bhqs", qa.float(), cl.float())
             + torch.einsum("bqhr,bsr->bhqs", qr.float(), krl.float()))
        ok = _valid(pos, window, C, off, cl.shape[1], s.device)
        return (s / scale).masked_fill(~ok[None, None, None, :], NEG_INF)

    def values(w, cl, krl):
        return torch.einsum("bhqs,bsc->bqhc", w, cl.float())

    if rules is None:
        w = torch.softmax(scores(q_abs, q_rope, cache_c, cache_kr, 0), dim=-1)
        return values(w, cache_c, cache_kr)
    row = shd.row_placements(cache_c)
    se, acc = shd.split_softmax(rules, scores, values, [q_abs, q_rope],
                                [cache_c, cache_kr], [row, row])
    return acc / se.permute(0, 2, 1)[..., None]


def mla_decode(cfg, p, x, cache_c, cache_kr, pos: int, *, window=0):
    """Absorbed-matmul decode: scores and values in the dc-wide latent
    space, per-head keys and values never built.  x: (B, 1, D); cache_c:
    (B, C, dc) normalized latents, cache_kr: (B, C, dr), the token's rows
    written into slot ``pos`` (or ``pos % C``) in place; a slot outside
    the cache raises ``IndexError``.  Returns (out, cache_c, cache_kr)."""
    B = x.shape[0]
    pos_arr = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, pos_arr)          # (B,1,H,dn/dr)
    c_n, k_rope = _mla_latent(cfg, p, x, pos_arr)        # (B,1,dc), (B,1,1,dr)

    C = cache_c.shape[1]
    slot = pos % C if window else pos
    if not 0 <= slot < C:
        raise IndexError(f"position {pos} outside a cache of {C} slots")
    shd.write_slot(cache_c, slot, c_n[:, 0])
    shd.write_slot(cache_kr, slot, k_rope[:, 0, 0])

    # absorb W_k_nope into the query
    q_abs = torch.einsum("bqhn,chn->bqhc", q_nope, p["w_k_nope"])
    ctx = _mla_cache_attention(shd.sharded(cache_c), cfg, q_abs, q_rope,
                               cache_c, cache_kr, pos, window)
    out = torch.einsum("bqhc,chv->bqhv", ctx.to(x.dtype), p["w_v"])
    return _merge(out) @ p["wo"], cache_c, cache_kr
