"""K7: flash attention (causal / sliding-window, GQA), forward only.

:func:`flash_attention_cuda` launches a hand-written Hopper kernel
(``csrc/flash_attention.cu``), the counterpart of the reference's Pallas
kernel ``src/repro/kernels/flash_attention.py:71``
(``flash_attention_pallas``; ``pallas_call`` at ``:90``).  Two routes,
by dtype (:func:`launch_plan`): bf16 goes to ``flash_fwd_wgmma_kernel``
on the tensor cores (wgmma, TMA; P rounded to bf16 for the PV product,
as the TPU kernel's ``jnp.dot(p, v)`` does), float32 to
``flash_fwd_kernel`` on the CUDA cores.
:func:`flash_attention_plain` is the reference's oracle
(``src/repro/kernels/ref.py:15``) in PyTorch: dense masked softmax in
float32.  Both take q (B, H, Sq, hd) and k, v (B, K, Skv, hd) with
H = K * G, align the queries to the end of the kv axis, and return q's
dtype.  ``scale`` defaults to ``1/sqrt(hd)`` and multiplies q in float32
(the model path pre-scales q in its own dtype, as the reference's
``attention`` does, and passes ``scale=1``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_sum import (_check_view, _require_cuda,
                                             _stream)

#: launches of the kernel wrapper (a run resets and reads it), by route:
#: bf16 (the served path) and float32
launches = {"flash_attention": 0, "flash_attention_fp32": 0}

HEAD_DIMS = (64, 96, 128, 256)
NEG_INF = -1e30
#: TMA's alignment: the base address and every stride it steps, in bytes
TMA_ALIGN = 16


def launch_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor) -> dict:
    """How :func:`flash_attention_cuda` launches K7 on these tensors, on
    any device (pure Python: the CPU tests rehearse it).  bf16 takes the
    tensor-core route: blocks of 128 query rows, kv tiles of 128 keys (64
    at hd 256), 128-byte swizzle (64-byte at hd 96, whose 192-byte rows
    split into three 64-byte chunks), and TMA maps over each tensor,
    which need a 16-byte-aligned base and byte strides that are multiples
    of 16 along every dim longer than 1: a view that breaks this raises
    ``ValueError`` naming it.  float32 takes the CUDA-core route: blocks
    of 64 query rows, kv tiles of 64."""
    hd = q.shape[-1]
    if q.dtype != torch.bfloat16:
        return {"route": "cuda_core", "kernel": "flash_fwd_kernel",
                "counter": "flash_attention_fp32", "block_q": 64,
                "block_k": 64}
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}'s base address is not {TMA_ALIGN}-byte "
                             f"aligned, as TMA needs")
        for dim, what in enumerate(("batch", "head", "position")):
            nbytes = t.stride(dim) * t.element_size()
            if t.shape[dim] > 1 and nbytes % TMA_ALIGN:
                raise ValueError(
                    f"{name}'s {what} stride of {nbytes} bytes is not a "
                    f"multiple of {TMA_ALIGN}, as TMA needs")
    return {"route": "wgmma", "kernel": "flash_fwd_wgmma_kernel",
            "counter": "flash_attention", "block_q": 128,
            "block_k": 128 if hd <= 128 else 64,
            "swizzle": 128 if hd % 64 == 0 else 64}


def _scale(hd: int, scale: Optional[float]) -> float:
    return 1.0 / np.sqrt(hd) if scale is None else float(scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax attention in float32 (``ref.flash_attention``)."""
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
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """K7 on the card (``csrc/flash_attention.cu``, ``flash_attention_fwd``).
    q, k, v may be strided views (the last dim contiguous; in bf16 also
    TMA's alignment, :func:`launch_plan`); bf16 or float32, all one dtype;
    hd in :data:`HEAD_DIMS`.  The output is a (B, H, Sq, hd) view of a
    (B, Sq, H, hd) tensor, the layout the model reshapes without a
    copy."""
    dev = _require_cuda(q, "flash_attention_cuda")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, Sq, hd), got {tuple(q.shape)}")
    B, H, Sq, hd = q.shape
    if k.dim() != 4:
        raise ValueError(f"k must be (B, K, Skv, hd), got {tuple(k.shape)}")
    K, Skv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes bf16 or "
                        f"float32")
    _check_view(q, "q", q.dtype, dev, (B, H, Sq, hd))
    _check_view(k, "k", q.dtype, dev, (B, K, Skv, hd))
    _check_view(v, "v", q.dtype, dev, (B, K, Skv, hd))
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not in {HEAD_DIMS}")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if causal and Sq > Skv:
        raise ValueError(f"causal attention with Sq {Sq} > Skv {Skv} leaves "
                         f"rows with no key")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev
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
        B, H, K, Sq, Skv, hd, int(bool(causal)), int(window),
        _scale(hd, scale), int(q.dtype == torch.bfloat16), _stream()),
        "flash_attention_fwd")
    launches[plan["counter"]] += 1
    return out
