"""One-pass fused GAT attention aggregation (K3), with its plain version.

``out[d, h] = sum_e softmax_d(leaky_relu(es[src_e, h] + ed[d, h], 0.2))_e
· hs[src_e, h]`` over the valid edges into ``d``, divided as
``acc / (l + 1e-9)``; a destination with no valid edge emits zeros.  The
Hopper counterpart of the reference's one-pass Pallas kernel
(``src/repro/kernels/gat_fused.py:132``): one CUDA block per
destination, one warp per head, lanes across the head width, so edge
logits and alphas never reach device memory (``csrc/gat_fused.cu``).

Edge validity is carried by the dst-grouped layout
(:func:`repro_torch.kernels.segment_sum.dst_layout` with the edge mask):
masked edges are not listed, so neither version reads them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_sum import (_check, _check_layout,
                                             _no_grad, _stream)

NEG_INF = -1e30
LEAKY_SLOPE = 0.2
MAX_HEADS = 32          # one warp per head in a block of at most 1024

launches = {"gat_attention": 0}


def gat_attention_plain(hs: torch.Tensor, es: torch.Tensor,
                        ed: torch.Tensor, edge_src: torch.Tensor,
                        order: torch.Tensor, row_ptr: torch.Tensor,
                        num_dst: int) -> torch.Tensor:
    """Plain PyTorch K3 over the dst-grouped layout: per-destination max,
    exponentials, denominator and weighted sum as whole-tensor ops."""
    heads = es.shape[1]
    hd = hs.shape[1] // heads
    e = order.long()
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(num_dst, device=hs.device), counts)
    src = edge_src.long()[e]
    pre = es[src] + ed[seg]                                   # (nnz, H)
    z = torch.where(pre >= 0, pre, LEAKY_SLOPE * pre)
    # the max only shifts the exponent (softmax is invariant to it), so
    # it is taken without a gradient
    m = torch.full((num_dst, heads), NEG_INF, dtype=z.dtype,
                   device=z.device).scatter_reduce(
        0, seg[:, None].expand_as(z), z.detach(), "amax")
    p = torch.exp(z - m[seg])
    den = torch.zeros((num_dst, heads), dtype=z.dtype,
                      device=z.device).index_add(0, seg, p)
    msgs = hs.reshape(-1, heads, hd)[src] * p[..., None]
    acc = torch.zeros((num_dst, heads, hd), dtype=hs.dtype,
                      device=hs.device).index_add(0, seg, msgs)
    return (acc / (den[..., None] + 1e-9)).reshape(num_dst, heads * hd)


def gat_attention_cuda(hs: torch.Tensor, es: torch.Tensor, ed: torch.Tensor,
                       edge_src: torch.Tensor, order: torch.Tensor,
                       row_ptr: torch.Tensor, num_dst: int) -> torch.Tensor:
    """K3 on the card (``csrc/gat_fused.cu``, ``gat_forward``)."""
    dev = hs.device
    if dev.type != "cuda":
        raise ValueError(f"gat_attention_cuda needs CUDA tensors, got {dev}")
    _check(hs, "hs", torch.float32, 2, dev)
    _check(es, "es", torch.float32, 2, dev)
    _check(ed, "ed", torch.float32, 2, dev)
    _check(edge_src, "edge_src", torch.int32, 1, dev)
    _check_layout(order, row_ptr, num_dst, dev)
    heads = es.shape[1]
    if not 0 < heads <= MAX_HEADS or hs.shape[1] % heads:
        raise ValueError(f"hs width {hs.shape[1]} must split into "
                         f"1..{MAX_HEADS} heads, got {heads}")
    if es.shape[0] != hs.shape[0] or tuple(ed.shape) != (num_dst, heads):
        raise ValueError(f"es {tuple(es.shape)} / ed {tuple(ed.shape)} do "
                         f"not match hs {tuple(hs.shape)} and num_dst "
                         f"{num_dst}")
    _no_grad(hs, es, ed)
    hd = hs.shape[1] // heads
    out = torch.empty((num_dst, heads * hd), dtype=torch.float32,
                      device=dev)
    if num_dst == 0 or hd == 0:
        return out
    lib = build.library("gat_fused")
    build.check(lib.gat_forward(
        hs.data_ptr(), es.data_ptr(), ed.data_ptr(), edge_src.data_ptr(),
        order.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), num_dst,
        heads, hd, _stream()), "gat_forward")
    launches["gat_attention"] += 1
    return out
