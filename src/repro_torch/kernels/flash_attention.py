"""K7: flash attention (causal / sliding-window, GQA), forward only.

:func:`flash_attention_cuda` launches a hand-written Hopper kernel
(``csrc/flash_attention.cu``), the counterpart of the reference's Pallas
kernel ``src/repro/kernels/flash_attention.py:71``
(``flash_attention_pallas``; ``pallas_call`` at ``:90``).  Two routes,
by dtype (:func:`launch_plan`), both on the tensor cores (wgmma, TMA):
bf16 goes to ``flash_fwd_wgmma_kernel`` (P rounded to bf16 for the PV
product, as the TPU kernel's ``jnp.dot(p, v)`` does), float32 to
``flash_fwd_tf32_kernel``, which splits every operand into TF32 hi and
lo parts and takes three TF32 products for each of Q·Kᵀ and P·V (hi·hi +
hi·lo + lo·hi), keeping float32's accuracy: one TF32 pass misses the
float32 bound of 1e-4 of the largest output.
:func:`flash_attention_plain` is the reference's oracle
(``src/repro/kernels/ref.py:15``) in PyTorch: dense masked softmax in
float32.  Both take q (B, H, Sq, hd), k (B, K, Skv, hd) and v (B, K,
Skv, hd_v) with H = K * G, align the queries to the end of the kv axis,
and return (B, H, Sq, hd_v) in q's dtype.  The kernel takes hd_v == hd
for hd in :data:`HEAD_DIMS`, and DeepSeek-V3's MLA prefill, q and k 192
wide (128 decompressed + 64 rotary columns) and v 128
(:data:`WIDTH_PAIRS`); the reference's Pallas kernel takes one width,
and its MLA reaches ``L.attention`` in XLA, which reads hd_v from v.  ``scale`` defaults to ``1/sqrt(hd)`` and multiplies q in float32
(the model path pre-scales q in its own dtype, as the reference's
``attention`` does, and passes ``scale=1``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_sum import (_check_tma, _check_view,
                                             _refuse_grad, _require_cuda,
                                             _stream)

#: launches of the kernel wrapper (a run resets and reads it), by route:
#: bf16 (the served path) and float32 (the TF32 split route)
launches = {"flash_attention": 0, "flash_attention_fp32": 0}

HEAD_DIMS = (64, 80, 96, 128, 256)
#: the (q/k width, v width) pairs the kernel takes: each width of
#: HEAD_DIMS with itself, and MLA's (192, 128) (DeepSeek-V3's prefill)
WIDTH_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
#: head widths that run on a wider kernel instance: hd 80 (Zamba2-2.7B)
#: on the hd-96 tiles, whose third 32-column chunk TMA fills with 16
#: columns of zeros past the tensor's 80 (an exact zero term in every Q·Kᵀ
#: sum; P·V's 16 extra columns are zeros that the TMA store clips)
TILE_WIDTH = {80: 96}
NEG_INF = -1e30
#: the shared memory a block may use on Hopper (227 KB), and an SM's (228
#: KB, of which each resident block reserves 1 KB), in bytes
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472


def check_widths(hd: int, hd_v: int) -> None:
    """Raise ``ValueError`` for a (q/k, v) width pair outside
    :data:`WIDTH_PAIRS`, naming both widths."""
    if (hd, hd_v) in WIDTH_PAIRS:
        return
    if hd == hd_v:
        raise ValueError(f"head width {hd} not in {HEAD_DIMS}")
    raise ValueError(f"q/k width {hd} with v width {hd_v}: the kernel "
                     f"takes the pairs {WIDTH_PAIRS}")


def launch_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor) -> dict:
    """How :func:`flash_attention_cuda` launches K7 on these tensors, on
    any device (pure Python: the CPU tests rehearse it).  Both routes
    read and write through TMA maps over each tensor, which need a
    16-byte-aligned base and byte strides that are multiples of 16 along
    every dim longer than 1: a view that breaks this raises
    ``ValueError`` naming it.  bf16: blocks of 128 query rows (two
    consumer warpgroups), kv tiles of 128 keys (64 at hd 256) in a ring
    of 2 stages, 128-byte swizzle (64-byte at hd 96, whose 192-byte rows
    split into three 64-byte chunks).  float32: blocks of 64 query rows
    (one consumer warpgroup), one stage of K and V beside their TF32
    hi/lo splits (K hi over K, V transposed), in tiles of 32 keys (16 at
    hd 256) so that two blocks share an SM at hd 64 and 96;
    128-byte swizzle.  A width pair outside :data:`WIDTH_PAIRS` raises
    ``ValueError`` (:func:`check_widths`); hd 80 runs on the hd-96 tiles
    (:data:`TILE_WIDTH`; ``tile_width`` and ``tile_width_v`` say which).
    Shared memory counts K's tiles at the q/k width and V's at the v
    width (MLA's (192, 128): 214 072 bytes in bf16, 197 656 in
    float32); ``smem_bytes`` is the dynamic shared memory a block asks
    for, within :data:`SMEM_PER_BLOCK` at every pair."""
    check_widths(q.shape[-1], v.shape[-1])
    hd = TILE_WIDTH.get(q.shape[-1], q.shape[-1])
    hd_v = TILE_WIDTH.get(v.shape[-1], v.shape[-1])
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_tma(t, name, ("batch", "head", "position"))
    if q.dtype == torch.bfloat16:
        block_k = 128 if hd <= 192 else 64
        stages = 2
        # the 1024-byte alignment slack, Q, the K and V ring, barriers
        smem = 1024 + 128 * hd * 2 + stages * block_k * (hd + hd_v) * 2 + \
            8 * (1 + 3 * stages)
        return {"route": "wgmma", "kernel": "flash_fwd_wgmma_kernel",
                "counter": "flash_attention", "tile_width": hd,
                "tile_width_v": hd_v, "block_q": 128,
                "block_k": block_k, "stages": stages,
                "swizzle": 128 if hd % 64 == 0 else 64, "smem_bytes": smem}
    block_k = 32 if hd <= 192 else 16
    # slack, Q hi and lo, K (raw, then hi) and K lo, raw V, V^T hi and lo,
    # barriers
    smem = 1024 + 2 * 64 * hd * 4 + 2 * block_k * hd * 4 + \
        3 * block_k * hd_v * 4 + 8 * 3
    return {"route": "wgmma_tf32", "kernel": "flash_fwd_tf32_kernel",
            "counter": "flash_attention_fp32", "tile_width": hd,
            "tile_width_v": hd_v, "block_q": 64,
            "block_k": block_k, "stages": 1, "swizzle": 128,
            "smem_bytes": smem,
            "blocks_per_sm": 2 if 2 * (smem + 1024) <= SMEM_PER_SM else 1}


def _scale(hd: int, scale: Optional[float]) -> float:
    return 1.0 / np.sqrt(hd) if scale is None else float(scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax attention in float32 (``ref.flash_attention``); the
    output takes v's width."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Sq, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg * _scale(hd, scale),
                          k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos + (Skv - Sq)
    if window:
        mask &= kpos > qpos + (Skv - Sq) - window
    logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", w, v.float())
    return out.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """K7 on the card (``csrc/flash_attention.cu``, ``flash_attention_fwd``).
    q, k, v may be strided views (the last dim contiguous, and TMA's
    alignment, :func:`launch_plan`); bf16 or float32, all one dtype; (hd,
    hd_v) in :data:`WIDTH_PAIRS`.  The output is a (B, H, Sq, hd_v) view
    of a (B, Sq, H, hd_v) tensor, the layout the model reshapes without a
    copy.  Forward only: an input that requires grad, with grad
    enabled, raises ``NotImplementedError`` (``_refuse_grad``)."""
    dev = _require_cuda(q, "flash_attention_cuda")
    _refuse_grad("flash_attention_cuda (K7)", q, k, v)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, Sq, hd), got {tuple(q.shape)}")
    B, H, Sq, hd = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"k and v must be (B, K, Skv, hd), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    K, Skv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes bf16 or "
                        f"float32")
    _check_view(q, "q", q.dtype, dev, (B, H, Sq, hd))
    _check_view(k, "k", q.dtype, dev, (B, K, Skv, hd))
    _check_view(v, "v", q.dtype, dev, (B, K, Skv, hd_v))
    check_widths(hd, hd_v)
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if causal and Sq > Skv:
        raise ValueError(f"causal attention with Sq {Sq} > Skv {Skv} leaves "
                         f"rows with no key")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=dev
                      ).transpose(1, 2)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("Skv 0: no key to attend to")
    plan = launch_plan(q, k, v, out)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    lib = build.library("flash_attention")
    build.check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        B, H, K, Sq, Skv, hd, hd_v, int(bool(causal)), int(window),
        _scale(hd, scale), int(q.dtype == torch.bfloat16), _stream()),
        "flash_attention_fwd")
    launches[plan["counter"]] += 1
    return out
