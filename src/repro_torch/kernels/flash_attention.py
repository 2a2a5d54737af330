"""K7: flash attention (causal / sliding-window, GQA) and its VJP.

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
``attention`` does, and passes ``scale=1``).  (192, 192) is
``examples/train_lm_100m``'s reduced Qwen2.5 at d_model 768 over 4 heads.

The VJP: :class:`FlashAttention` runs K7 with each row's log-sum-exp
written beside the output (``return_lse``) and, in its backward,
:func:`flash_attention_bwd_cuda`: two hand-written kernels
(``csrc/flash_attention_bwd.cu``, ``csrc/flash_attention_bwd_tf32.cu``),
dQ (which first writes D = <dO, o> a row) and then dK/dV, no atomics,
both routes on the tensor cores (wgmma, TMA): bf16 with P and dS
rounded to bf16 for the accumulating products, as the forward rounds P;
float32 on TF32 hi/lo splits, three products each, as the forward's
float32 route (:func:`bwd_launch_plan`).  They replace no TPU kernel: the reference
trains through XLA's autodiff of
``L.attention``.  :func:`flash_attention_bwd_plain` is the same
FlashAttention-2 formulas in PyTorch, in float32.  The raw
:func:`flash_attention_cuda` stays forward-only: called with grad on an
input that requires it, it raises and names the Function.
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

#: launches of the kernel wrappers (a run resets and reads them), by
#: route: the forward in bf16 (the served path) and float32 (the TF32
#: split route), and the backward's two kernels in each dtype
launches = {"flash_attention": 0, "flash_attention_fp32": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0,
            "flash_attention_bwd_dq_fp32": 0,
            "flash_attention_bwd_dkdv_fp32": 0}

HEAD_DIMS = (64, 80, 96, 128, 256)
#: the (q/k width, v width) pairs the kernel takes: each width of
#: HEAD_DIMS with itself, MLA's (192, 128) (DeepSeek-V3's prefill) and
#: (192, 192) (train_lm_100m's 768-wide reduced Qwen2.5 over 4 heads)
WIDTH_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128), (192, 192))
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
    float32; (192, 192) takes 64-key tiles in bf16, 148 536 bytes, and
    222 232 in float32); ``smem_bytes`` is the dynamic shared memory a
    block asks for, within :data:`SMEM_PER_BLOCK` at every pair."""
    check_widths(q.shape[-1], v.shape[-1])
    hd = TILE_WIDTH.get(q.shape[-1], q.shape[-1])
    hd_v = TILE_WIDTH.get(v.shape[-1], v.shape[-1])
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_tma(t, name, ("batch", "head", "position"))
    if q.dtype == torch.bfloat16:
        # (192, 192)'s two stages of 128-key tiles and Q would take 241 KB
        block_k = 128 if hd <= 192 and hd + hd_v <= 320 else 64
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


def _mask(Sq: int, Skv: int, causal: bool, window: int, device
          ) -> torch.Tensor:
    """(Sq, Skv): True where query i sees key j, the queries aligned to
    the end of the kv axis."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _logits(q, k, causal, window, scale):
    """The masked float32 scores (B, K, G, Sq, Skv), masked entries
    NEG_INF, and the mask."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    qg = q.reshape(B, K, H // K, Sq, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg * _scale(hd, scale),
                          k.float())
    mask = _mask(Sq, Skv, causal, window, q.device)
    return logits.masked_fill(~mask, NEG_INF), mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """Dense softmax attention in float32 (``ref.flash_attention``); the
    output takes v's width.  With ``return_lse`` also each row's
    log-sum-exp, (B, H, Sq) float32, as the kernel writes it."""
    B, H, Sq, _ = q.shape
    logits, _ = _logits(q, k, causal, window, scale)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", w, v.float())
    out = out.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(B, H, Sq)
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """K7 on the card (``csrc/flash_attention.cu``, ``flash_attention_fwd``).
    q, k, v may be strided views (the last dim contiguous, and TMA's
    alignment, :func:`launch_plan`); bf16 or float32, all one dtype; (hd,
    hd_v) in :data:`WIDTH_PAIRS`.  The output is a (B, H, Sq, hd_v) view
    of a (B, Sq, H, hd_v) tensor, the layout the model reshapes without a
    copy.  With ``return_lse``, returns ``(out, lse)``: the kernel also
    writes each row's log-sum-exp, (B, H, Sq) float32 (serving passes
    none).  Forward only: an input that requires grad, with grad
    enabled, raises ``NotImplementedError`` naming
    :class:`FlashAttention` (``_refuse_grad``)."""
    dev = _require_cuda(q, "flash_attention_cuda")
    _refuse_grad("flash_attention_cuda (K7)",
                 "kernels.flash_attention.FlashAttention", q, k, v)
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
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if Skv == 0:
        raise ValueError("Skv 0: no key to attend to")
    plan = launch_plan(q, k, v, out)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    lib = build.library("flash_attention")
    build.check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), strides,
        B, H, K, Sq, Skv, hd, hd_v, int(bool(causal)), int(window),
        _scale(hd, scale), int(q.dtype == torch.bfloat16), _stream()),
        "flash_attention_fwd")
    launches[plan["counter"]] += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# the VJP
# ---------------------------------------------------------------------------

#: the backward kernels' rows: a consumer warpgroup's (bf16), a dQ block's
#: and a dK/dV block's (float32); a block's threads (a producer warpgroup
#: and two consumer warpgroups), but for the float32 dQ kernel's (a
#: consumer warpgroup and a producer warp)
BWD_TC_ROWS = 64
BWD_TC_THREADS = 384
BWD_TF32_DQ_THREADS = 160


def bwd_launch_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> dict:
    """How :func:`flash_attention_bwd_cuda` launches K7's VJP on these
    tensors, on any device (pure Python: the CPU tests rehearse it).  A
    width pair outside :data:`WIDTH_PAIRS` raises ``ValueError``.  Both
    routes read q, k, v and the output cotangent through TMA maps on the
    forward's tiles (``tile_width``: hd 80 on the hd-96 tiles): a
    16-byte-aligned base and byte strides in multiples of 16, else
    ``ValueError`` naming the tensor.  ``library`` and ``entries`` name
    the built library and its two C entry points (dQ, then dK/dV);
    ``smem_dq`` / ``smem_dkdv`` are what the kernels ask for, within
    :data:`SMEM_PER_BLOCK`.

    bf16 (``route`` "wgmma"): ``flash_bwd_dq_wgmma_kernel`` over (H, B,
    query tiles of 128 rows, the last first), ``flash_bwd_dkdv_wgmma_kernel``
    over (key tiles of 64, K, B), 384 threads each (a producer warpgroup
    issuing TMA, two consumer warpgroups of 64 rows); K/V tiles of 64 keys
    (dQ) and Q/dO tiles of 64 queries (dK/dV) in rings of ``stages_dq`` /
    ``stages_dkdv`` stages (dQ at width 256: 1, the only ring that would
    not fit twice beside its 128-row Q and dO); ``swizzle`` 64 B at the
    hd-96 tiles, else 128 (``TcTile`` in the source).

    float32 (``route`` "wgmma_tf32"): ``flash_bwd_dq_tf32_kernel`` over
    (query tiles of 64, the last first, H, B), 160 threads (a consumer
    warpgroup, a producer warp), Q and dO resident and K/V tiles of
    ``walk_rows_dq`` keys (64 to width 128, 32 at the (192, *) pairs, 16
    at 256) in a ring of ``stages_dq``; ``flash_bwd_dkdv_tf32_kernel`` over (key tiles
    of 64, K, B), 384 threads (a producer warpgroup, two consumer
    warpgroups split by output), K and V resident and Q/dO tiles of
    ``walk_rows_dkdv`` queries (32; 16 at 256) landing in a ring of
    ``stages_dkdv``, split into one set of buffers.  Every operand split into TF32 hi and lo, 128-byte
    swizzle; two stages where they fit (``TileT`` in the source)."""
    hd, hd_v = q.shape[-1], v.shape[-1]
    check_widths(hd, hd_v)
    B, H, Sq = q.shape[0], q.shape[1], q.shape[2]
    K, Skv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tma(t, name, ("batch", "head", "position"))
    tw, twv = TILE_WIDTH.get(hd, hd), TILE_WIDTH.get(hd_v, hd_v)
    rows = BWD_TC_ROWS
    if q.dtype == torch.bfloat16:
        k_bytes, v_bytes = rows * tw * 2, rows * twv * 2
        # dQ: slack, Q and dO of 128 rows, the K/V ring, barriers
        fixed = 1024 + 2 * (k_bytes + v_bytes)
        stages_dq = 2 if fixed + 2 * (k_bytes + v_bytes) + 8 * 7 <= \
            SMEM_PER_BLOCK else 1
        smem_dq = fixed + stages_dq * (k_bytes + v_bytes) + \
            8 * (1 + 3 * stages_dq)
        # dK/dV: slack, K and V, the Q/dO ring of 2, two float32 P^T tiles,
        # barriers
        smem_dkdv = 1024 + 3 * (k_bytes + v_bytes) + 2 * 4 * rows * rows + \
            8 * 5
        return {"route": "wgmma",
                "kernels": ("flash_bwd_dq_wgmma_kernel",
                            "flash_bwd_dkdv_wgmma_kernel"),
                "counters": ("flash_attention_bwd_dq",
                             "flash_attention_bwd_dkdv"),
                "library": "flash_attention_bwd",
                "entries": ("flash_attention_bwd_dq",
                            "flash_attention_bwd_dkdv"),
                "tile_width": tw, "tile_width_v": twv,
                "swizzle": 128 if tw % 64 == 0 else 64,
                "block_rows_dq": 2 * rows, "block_rows_dkdv": rows,
                "walk_rows_dq": rows, "walk_rows_dkdv": rows,
                "threads_dq": BWD_TC_THREADS,
                "threads_dkdv": BWD_TC_THREADS,
                "stages_dq": stages_dq, "stages_dkdv": 2,
                "grid_dq": (H, B, -(-Sq // (2 * rows))),
                "grid_dkdv": (-(-Skv // rows), K, B),
                "smem_dq": smem_dq, "smem_dkdv": smem_dkdv}
    w = tw + twv
    # dQ: slack, Q and dO raw, dS hi/lo; a stage holds K (hi over the
    # landed tile), K lo, V (hi), V lo; barriers
    bk = 64 if w <= 256 else 32 if w <= 384 else 16
    dq_fixed, dq_stage = 1024 + 256 * w + 512 * bk, 8 * bk * w
    stages_dq = 2 if dq_fixed + 2 * dq_stage + 8 * 5 <= SMEM_PER_BLOCK \
        else 1
    # dK/dV: slack, K and V raw, the single buffers (Q lo, dO lo, P^T and
    # dS^T hi/lo); a stage holds Q and dO as they land (then their hi);
    # barriers
    bq = 32 if w <= 384 else 16
    dkdv_fixed = 1024 + 256 * w + bq * (4 * w + 1024)
    dkdv_stage = 4 * bq * w
    stages_dkdv = 2 if dkdv_fixed + 2 * dkdv_stage + 8 * 5 <= \
        SMEM_PER_BLOCK else 1
    return {"route": "wgmma_tf32",
            "kernels": ("flash_bwd_dq_tf32_kernel",
                        "flash_bwd_dkdv_tf32_kernel"),
            "counters": ("flash_attention_bwd_dq_fp32",
                         "flash_attention_bwd_dkdv_fp32"),
            "library": "flash_attention_bwd_tf32",
            "entries": ("flash_attention_bwd_tf32_dq",
                        "flash_attention_bwd_tf32_dkdv"),
            "tile_width": tw, "tile_width_v": twv, "swizzle": 128,
            "block_rows_dq": rows, "block_rows_dkdv": rows,
            "walk_rows_dq": bk, "walk_rows_dkdv": bq,
            "threads_dq": BWD_TF32_DQ_THREADS,
            "threads_dkdv": BWD_TC_THREADS,
            "stages_dq": stages_dq, "stages_dkdv": stages_dkdv,
            "grid_dq": (-(-Sq // rows), H, B),
            "grid_dkdv": (-(-Skv // rows), K, B),
            "smem_dq": dq_fixed + stages_dq * dq_stage
            + 8 * (1 + 2 * stages_dq),
            "smem_dkdv": dkdv_fixed + stages_dkdv * dkdv_stage
            + 8 * (1 + 2 * stages_dkdv)}


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int = 0, scale: Optional[float] = None):
    """FlashAttention-2's backward in float32: P recomputed from ``lse``
    under the forward's masks, ``D = <dO, o>`` a row, ``dS = P (dO V^T -
    D)``, ``dV = P^T dO``, ``dK = scale dS^T Q``, ``dQ = scale dS K``,
    GQA's groups summed into their kv head.  Returns ``(dq, dk, dv)`` in
    the inputs' dtypes."""
    B, H, Sq, hd = q.shape
    K = k.shape[1]
    G = H // K
    s = _scale(hd, scale)
    logits, mask = _logits(q, k, causal, window, scale)
    p = torch.exp(logits - lse.float().reshape(B, K, G, Sq, 1))
    p = p.masked_fill(~mask, 0.0)
    dog = do.float().reshape(B, K, G, Sq, -1)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dog, v.float())
    D = (dog * o.float().reshape(B, K, G, Sq, -1)).sum(-1, keepdim=True)
    ds = p * (dp - D)
    dv = torch.einsum("bkgqs,bkgqh->bksh", p, dog)
    dk = s * torch.einsum("bkgqs,bkgqh->bksh", ds,
                          q.float().reshape(B, K, G, Sq, hd))
    dq = s * torch.einsum("bkgqs,bksh->bkgqh", ds, k.float())
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None):
    """K7's VJP on the card (``csrc/flash_attention_bwd.cu`` in bf16,
    ``csrc/flash_attention_bwd_tf32.cu`` in float32): the dQ kernel
    (which writes D first), then the dK/dV kernel, on the current
    stream.  q, k, v, o (the forward's output) and do may be strided views
    with the last dim contiguous, all one dtype (bf16 or float32); lse is
    the forward's, (B, H, Sq) float32.  Returns ``(dq, dk, dv)``, each a
    (B, heads, S, width) view of a (B, S, heads, width) tensor, in the
    inputs' dtype.  q, k, v and do are read through TMA maps
    (:func:`bwd_launch_plan`'s alignment).  Each launch counts under
    :func:`bwd_launch_plan`'s counter; a refused launch raises.  Nothing
    differentiates it: an input that requires grad, with grad enabled,
    raises ``NotImplementedError`` (``_refuse_grad``)."""
    _refuse_grad("flash_attention_bwd_cuda (K7's VJP, no double backward)",
                 None, q, k, v, o, do, lse)
    plan, grads, args = _bwd_prepare(q, k, v, o, do, lse, causal, window,
                                     scale)
    if args is not None:
        for which in (0, 1):
            _bwd_launch(plan, which, args)
    return grads


def _bwd_prepare(q, k, v, o, do, lse, causal, window, scale):
    """Check the VJP's inputs and allocate its outputs and D: ``(plan,
    (dq, dk, dv), args)``, ``args`` the C arguments of both kernels (None
    when there is nothing to launch)."""
    dev = _require_cuda(q, "flash_attention_bwd_cuda")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    K, Skv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q has dtype {q.dtype}; the kernels take bf16 or "
                        f"float32")
    for name, t, shape in (("q", q, (B, H, Sq, hd)), ("k", k, (B, K, Skv, hd)),
                           ("v", v, (B, K, Skv, hd_v)),
                           ("o", o, (B, H, Sq, hd_v)),
                           ("do", do, (B, H, Sq, hd_v))):
        _check_view(t, name, q.dtype, dev, shape)
    _check_view(lse, "lse", torch.float32, dev, (B, H, Sq))
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if causal and Sq > Skv:
        raise ValueError(f"causal attention with Sq {Sq} > Skv {Skv} leaves "
                         f"rows with no key")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    plan = bwd_launch_plan(q, k, v)
    _check_tma(do, "do", ("batch", "head", "position"))
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev
                     ).transpose(1, 2)
    dk = torch.empty((B, Skv, K, hd), dtype=q.dtype, device=dev
                     ).transpose(1, 2)
    dv = torch.empty((B, Skv, K, hd_v), dtype=q.dtype, device=dev
                     ).transpose(1, 2)
    if dq.numel() == 0 or Skv == 0:
        return plan, (dq.zero_(), dk.zero_(), dv.zero_()), None
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 24)(
        *(t.stride(i) for t in (q, k, v, o, do, dq, dk, dv) for i in range(3)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), strides, B, H, K, Sq, Skv, hd,
            hd_v, int(bool(causal)), int(window), _scale(hd, scale),
            _stream())
    # D lives as long as the arguments that point at it
    return plan, (dq, dk, dv), args + (D,)


def _bwd_launch(plan: dict, which: int, args) -> None:
    """The plan's backward kernel ``which`` (0 dQ, 1 dK/dV) on
    ``_bwd_prepare``'s arguments, counted."""
    fn = plan["entries"][which]
    build.check(getattr(build.library(plan["library"]), fn)(*args[:-1]), fn)
    launches[plan["counters"][which]] += 1


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether a (B, heads, S, width) view passes :func:`_check_tma`."""
    try:
        _check_tma(t, "t", ("batch", "head", "position"))
    except ValueError:
        return False
    return True


class FlashAttention(torch.autograd.Function):
    """K7 with its VJP: the forward launches K7 with the row log-sum-exp
    and saves q, k, v, the output and lse; the backward launches
    :func:`flash_attention_bwd_cuda`.  Both look the wrappers up at call
    time (the CPU tests stand the plain versions in for them)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1 or not _tma_ready(dout):
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                              **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_card(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """K7 on a CUDA tensor as ``ops`` runs it: through
    :class:`FlashAttention` where autograd records the call (grad enabled
    and an input that requires grad), else the forward alone, with no
    lse written or saved."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                scale=scale)
