"""Shared transformer building blocks (PyTorch port of the reference's
``models/transformer/layers.py``).

Params are plain nested dicts of tensors, with the reference's keys; the
layer stack is a list of per-layer dicts (the reference stacks a leading
``num_layers`` axis for ``lax.scan``; the port loops over layers).

:func:`attention` runs the reference's chunked softmax as plain PyTorch
on the CPU; on a CUDA tensor it launches the flash-attention kernel (K7,
``repro_torch.kernels.flash_attention``) for the calls that kernel
computes, and raises for any other.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, segment_sum
from repro_torch.launch import sharding as shd

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def cache_dtype_of(cfg) -> torch.dtype:
    return dtype_of(cfg.cache_dtype or cfg.compute_dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, device, std: float = 1.0,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``std * N(0, 1)`` drawn in float32 from ``gen`` (which lives on
    ``device``), then cast to ``dtype``.  The draw is scaled in place, so
    one float32 copy is live besides the result (a float32 (256, 7168,
    2048) expert weight is 15 GB)."""
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return x.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    return normal(gen, (in_dim, out_dim), device, 1.0 / np.sqrt(in_dim),
                  dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def _mean_last(t: torch.Tensor) -> torch.Tensor:
    """The mean over the last dim, kept.  On a DTensor whose last dim is
    split (the SSM's gated norm over ``model``): the sum over the shards,
    all-reduced, over the width (:func:`~repro_torch.launch.sharding.
    reduced`), so no other dim gets split."""
    if shd.sharded(t):
        return shd.reduced(t.sum(-1, keepdim=True)) / t.shape[-1]
    return t.mean(-1, keepdim=True)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = _mean_last(xf.square())
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = _mean_last(xf)
    var = _mean_last((xf - mu).square()) if shd.sharded(xf) else \
        xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def apply_norm(cfg, x, p):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def init_norm(cfg, dim: int, device):
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(dim, device=device),
                "bias": torch.zeros(dim, device=device)}
    return {"scale": torch.ones(dim, device=device)}


# ---------------------------------------------------------------------------
# rotary embeddings (standard / partial / M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_frac: float = 1.0, mrope_sections=None) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S), or (3, B, S) for M-RoPE.  The
    first ``hd * rotary_frac`` (rounded down to even) dims rotate.  With
    ``mrope_sections`` (Qwen2-VL's (t, h, w) band counts, summing to the
    rotated dims' half) the frequency bands split into three sections in
    order, each rotating by its own position stream."""
    hd = x.shape[-1]
    rot = int(hd * rotary_frac)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = torch.from_numpy(np.asarray(rope_freqs(rot, theta), np.float32)
                             ).to(x.device)
    if mrope_sections is not None:
        if sum(mrope_sections) != rot // 2 or positions.dim() != 3 or \
                positions.shape[0] != 3:
            raise ValueError(
                f"M-RoPE sections {tuple(mrope_sections)} over {rot // 2} "
                f"bands with positions {tuple(positions.shape)}: the "
                f"sections must sum to the bands, positions be (3, B, S)")
        # each band's position stream: (B, S, rot/2)
        pos = torch.cat([positions[i][..., None].expand(
            positions.shape[1:] + (n,)) for i, n in
            enumerate(mrope_sections)], dim=-1)
        angles = pos.float() * freqs
    else:
        angles = positions[..., None].float() * freqs         # (B,S,rot/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(cfg, gen, d_model: int, d_ff: int, dtype, device):
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype, device),
         "w_out": dense_init(gen, d_ff, d_model, dtype, device)}
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device)
    return p


def _act(cfg, v):
    if cfg.act == "silu":
        return F.silu(v)
    return F.gelu(v, approximate="tanh")


def mlp(cfg, x: torch.Tensor, p) -> torch.Tensor:
    x = shd.gather_seq(x)
    h = x @ p["w_in"]
    if cfg.mlp_gated:
        h = _act(cfg, x @ p["w_gate"]) * h
    else:
        h = _act(cfg, h)
    return shd.scatter_seq(h @ p["w_out"])


# ---------------------------------------------------------------------------
# attention: the reference's chunked softmax (CPU), K7 (CUDA)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _attention_plain(qs, k, v, *, causal, q_offset, window, kv_valid_len,
                     q_chunk):
    """The reference's chunked softmax (``layers.py:152`` ``attention``)
    over query blocks, in float32; the CPU branch of :func:`attention`.
    qs: (B, Sq, H, hd) already scaled; returns (B, Sq, H, hd_v) float32.

    The port has three plain attention softmaxes on purpose, each the
    torch copy of the reference function it is held against: this one;
    ``kernels.flash_attention.flash_attention_plain`` (``ref.py:15``,
    K7's oracle, dense); and the masked softmax over the whole cache in
    ``attention.gqa_decode`` (``attention.py:106-113``)."""
    B, Sq, H, hd = qs.shape
    K, Skv = k.shape[2], k.shape[1]
    qg = qs.reshape(B, Sq, K, H // K, hd)
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(Skv, device=qg.device)

    def block(q_blk, q_pos):
        logits = torch.einsum("bqkgh,bskh->bkgqs", q_blk.float(), kf)
        mask = torch.ones((q_blk.shape[1], Skv), dtype=torch.bool,
                          device=qg.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_valid_len is not None:
            mask &= (kv_pos < kv_valid_len)[None, :]
        logits = logits.masked_fill(~mask[None, None, None], NEG_INF)
        w = torch.softmax(logits, dim=-1)
        return torch.einsum("bkgqs,bskh->bqkgh", w, vf)

    if Sq <= q_chunk:
        out = block(qg, q_offset + torch.arange(Sq, device=qg.device))
    else:
        outs = []
        for s0 in range(0, Sq, q_chunk):
            # the reference pads the last block; its padded rows are cut
            qb = qg[:, s0:s0 + q_chunk]
            outs.append(block(qb, q_offset + s0 + torch.arange(
                qb.shape[1], device=qg.device)))
        out = torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, v.shape[-1])


def _attention_card(qs, k, v, *, causal, q_offset, window, kv_valid_len,
                    q_chunk):
    """The CUDA branch of :func:`attention`: K7 with ``scale=1`` on the
    pre-scaled q.  K7 aligns the queries to the end of the kv axis, and
    only its causal and window masks read that offset: a masked call
    needs ``q_offset == Skv - Sq``, a non-causal call without a window
    (Whisper's encoder, cross attention) takes any ``q_offset``, which
    nothing then reads.  A misaligned masked call or a ``kv_valid_len``
    (no caller of the reference passes one) raises.  v passes at its own
    width (MLA's 128 beside q and k's 192; K7 raises for a pair it does
    not take).  K7 tiles the queries itself (no ``q_chunk``).  Where
    autograd records the call (training), ``ops`` runs K7 through
    ``FlashAttention``, whose backward is K7's VJP kernels."""
    Sq, Skv = qs.shape[1], k.shape[1]
    if kv_valid_len is not None:
        raise NotImplementedError(
            "attention with kv_valid_len on the card: K7 takes no ragged "
            "cache, and no caller passes one")
    if (causal or window) and int(q_offset) != Skv - Sq:
        raise NotImplementedError(
            f"masked attention on the card with q_offset {int(q_offset)}: "
            f"K7's causal and window masks align the queries to the end "
            f"of the kv axis (q_offset {Skv - Sq})")
    out = ops.flash_attention(qs.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, scale=1.0)
    return out.transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset, window: int = 0,
              kv_valid_len=None, q_chunk: int = 1024) -> torch.Tensor:
    """Grouped-query attention.  q: (B, Sq, H, hd); k: (B, Skv, K, hd);
    v: (B, Skv, K, hd_v) with H = K * G; the output, (B, Sq, H, hd_v),
    has q's dtype.  ``q_offset``: absolute
    position of q[0]; ``window`` > 0 masks to ``|i - j| < window``;
    ``kv_valid_len`` masks kv positions >= it.

    As in the reference, q is scaled by ``1/sqrt(hd)`` in its own dtype
    and the rest runs in float32.  On the CPU: the reference's chunked
    softmax over blocks of ``q_chunk`` queries.  On a CUDA tensor: K7
    (:func:`_attention_card`)."""
    rules = shd.sharded(q, k, v)
    if rules is not None:
        return _attention_sharded(rules, q, k, v, causal=causal,
                                  q_offset=q_offset, window=window,
                                  kv_valid_len=kv_valid_len, q_chunk=q_chunk)
    B, Sq, H, hd = q.shape
    qs = q * (1.0 / np.sqrt(hd))
    run = segment_sum.pick(_attention_card, _attention_plain, q)
    out = run(qs, k, v, causal=causal, q_offset=q_offset, window=window,
              kv_valid_len=kv_valid_len, q_chunk=q_chunk)
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _attention_sharded(rules, q, k, v, **kw):
    """:func:`attention` on DTensors under sharding rules, on each
    device's shards (``local_map``): batch over the rules' batch axis,
    query heads over ``model`` where they divide, the sequence whole.
    K and V heads go over ``model`` where they divide too; else each
    rank takes all of them and uses its query heads' groups (a group of
    G query heads a KV head).  Where the query heads do not divide, or a
    rank's heads would straddle groups, every ``model`` rank computes all
    heads."""
    H, K = q.shape[2], k.shape[2]
    m, G = rules.model_size, H // K
    b = rules.batch_axis
    hl = H // m
    h_ax = "model" if H % m == 0 and (hl % G == 0 or G % hl == 0) \
        else None
    kv_ax = "model" if h_ax and K % m == 0 else None
    spec_q, spec_kv = (b, None, h_ax, None), (b, None, kv_ax, None)

    def local(ql, kl, vl):
        if h_ax and not kv_ax:
            r = rules.mesh.get_local_rank("model")
            lo, hi = r * hl // G, ((r + 1) * hl - 1) // G + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return attention(ql, kl, vl, **kw)

    return shd.on_shards(local, [spec_q, spec_kv, spec_kv], spec_q,
                         rules)(q, k, v)


# ---------------------------------------------------------------------------
# token embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(cfg, gen, dtype, device):
    V = cfg.padded_vocab
    p = {"embedding": normal(gen, (V, cfg.d_model), device, 0.02, dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, V, dtype, device)
    return p


def embed(cfg, p, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens``.  Under sharding rules (a table split by
    vocabulary over ``model``) the masked partial rows are reduced to the
    residual stream's spec here, before anything is added to them."""
    x = F.embedding(tokens.long(), p["embedding"])
    if cfg.embed_scale:
        x = x.float() * float(np.sqrt(cfg.d_model).astype(np.float32))
    return shd.scatter_seq(x.to(dtype_of(cfg.compute_dtype)))


def unembed(cfg, p, x: torch.Tensor) -> torch.Tensor:
    x = shd.gather_seq(x)
    if cfg.tie_embeddings:
        return x @ p["embedding"].t()
    return x @ p["lm_head"]
