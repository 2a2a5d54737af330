"""Destination-grouped segmented reductions: the GNN Gather step.

Two kernels, each with its plain PyTorch version beside it:

* :func:`gather_scale_segment_sum_cuda` (K1) —
  ``out[d] = sum_{e: dst_e=d} coef_e * h[src_e]`` without the (E, F)
  message tensor; the Hopper counterpart of the reference's fused Pallas
  kernel (``src/repro/kernels/segment_sum.py:320``).
* :func:`segment_sum_cuda` (K2) — ``out[d] = sum_{e: seg_e=d} msgs[e]``;
  the counterpart of the blocked scatter (``segment_sum.py:138``).

The TPU kernels tile the reduction as one-hot matmuls because a TPU has
no efficient scatter.  These walk a dst-grouped layout instead:
``order`` lists the edges stably sorted by destination and
``row_ptr[d]:row_ptr[d+1]`` is destination ``d``'s range
(:func:`dst_layout`).  One CUDA block owns one destination row and writes
it once, so there are no atomics and the sum is bitwise repeatable.  See
``csrc/segment_sum.cu`` for the bound.

The plain versions take the same arguments, layout included, so the CPU
tests exercise exactly what the kernels read; they stay differentiable
through autograd.  :mod:`repro_torch.kernels.ops` picks one or the other
by the tensor's device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

#: launches per kernel wrapper (plain integers; a run resets and reads
#: them to show that a path went through the kernels)
launches = {"gather_scale_segment_sum": 0, "segment_sum": 0}


def dst_layout(edge_dst: np.ndarray, num_dst: int,
               mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side dst-grouped layout of an edge list: ``(order, row_ptr)``
    as int32, ``order`` a stable argsort of ``edge_dst`` over the edges
    with ``mask`` set (all edges when ``mask`` is None) and ``row_ptr``
    the (num_dst + 1,) prefix sum of their per-destination counts.

    Masked pad slots are left out: every caller folds the mask into the
    coefficient or the message, so they add exact zeros, and keeping
    them would pile every pad slot (dst 0) onto one block."""
    edge_dst = np.asarray(edge_dst, np.int64)
    keep = (np.arange(len(edge_dst)) if mask is None
            else np.flatnonzero(np.asarray(mask, bool)))
    order = keep[np.argsort(edge_dst[keep], kind="stable")]
    counts = np.bincount(edge_dst[keep], minlength=num_dst)
    row_ptr = np.zeros(num_dst + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return order.astype(np.int32), row_ptr.astype(np.int32)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_layout(order: torch.Tensor, row_ptr: torch.Tensor, num_dst: int,
                  device: torch.device) -> None:
    _check(order, "order", torch.int32, 1, device)
    _check(row_ptr, "row_ptr", torch.int32, 1, device)
    if row_ptr.shape[0] != num_dst + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries, "
                         f"expected num_dst + 1 = {num_dst + 1}")


def _no_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the Hopper aggregation kernels are forward-only; their "
            "backward kernels arrive with the training slice")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K1: fused gather -> scale -> segment-sum
# ---------------------------------------------------------------------------

def gather_scale_segment_sum_plain(h: torch.Tensor, edge_src: torch.Tensor,
                                   coef: torch.Tensor, order: torch.Tensor,
                                   row_ptr: torch.Tensor,
                                   num_dst: int) -> torch.Tensor:
    """Plain PyTorch K1 over the dst-grouped layout:
    ``index_add_`` of the scaled source rows of the listed edges."""
    e = order.long()
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(num_dst, device=h.device), counts)
    msgs = h[edge_src.long()[e]] * coef[e][:, None]
    out = torch.zeros((num_dst, h.shape[1]), dtype=h.dtype, device=h.device)
    return out.index_add(0, seg, msgs)


def gather_scale_segment_sum_cuda(h: torch.Tensor, edge_src: torch.Tensor,
                                  coef: torch.Tensor, order: torch.Tensor,
                                  row_ptr: torch.Tensor,
                                  num_dst: int) -> torch.Tensor:
    """K1 on the card (``csrc/segment_sum.cu``, ``gss_forward``)."""
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"gather_scale_segment_sum_cuda needs CUDA "
                         f"tensors, got {dev}")
    _check(h, "h", torch.float32, 2, dev)
    _check(edge_src, "edge_src", torch.int32, 1, dev)
    _check(coef, "coef", torch.float32, 1, dev)
    if coef.shape[0] != edge_src.shape[0]:
        raise ValueError("coef and edge_src differ in length")
    _check_layout(order, row_ptr, num_dst, dev)
    _no_grad(h, coef)
    F = h.shape[1]
    out = torch.empty((num_dst, F), dtype=torch.float32, device=dev)
    if num_dst == 0 or F == 0:
        return out
    lib = build.library("segment_sum")
    build.check(lib.gss_forward(
        h.data_ptr(), edge_src.data_ptr(), coef.data_ptr(),
        order.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
        num_dst, F, _stream()), "gss_forward")
    launches["gather_scale_segment_sum"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: segment-sum of per-edge messages
# ---------------------------------------------------------------------------

def segment_sum_plain(msgs: torch.Tensor, order: torch.Tensor,
                      row_ptr: torch.Tensor, num_dst: int) -> torch.Tensor:
    """Plain PyTorch K2 over the dst-grouped layout: ``index_add_`` of
    the listed message rows."""
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(num_dst, device=msgs.device), counts)
    out = torch.zeros((num_dst, msgs.shape[1]), dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add(0, seg, msgs[order.long()])


def segment_sum_cuda(msgs: torch.Tensor, order: torch.Tensor,
                     row_ptr: torch.Tensor, num_dst: int) -> torch.Tensor:
    """K2 on the card (``csrc/segment_sum.cu``, ``seg_forward``)."""
    dev = msgs.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_cuda needs CUDA tensors, got {dev}")
    _check(msgs, "msgs", torch.float32, 2, dev)
    _check_layout(order, row_ptr, num_dst, dev)
    _no_grad(msgs)
    F = msgs.shape[1]
    out = torch.empty((num_dst, F), dtype=torch.float32, device=dev)
    if num_dst == 0 or F == 0:
        return out
    lib = build.library("segment_sum")
    build.check(lib.seg_forward(
        msgs.data_ptr(), order.data_ptr(), row_ptr.data_ptr(),
        out.data_ptr(), num_dst, F, _stream()), "seg_forward")
    launches["segment_sum"] += 1
    return out
