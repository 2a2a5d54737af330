"""One-pass fused GAT attention aggregation (K3), its plain version, and
its VJP.

``out[d, h] = sum_e softmax_d(leaky_relu(es[src_e, h] + ed[d, h], 0.2))_e
· hs[src_e, h]`` over the valid edges into ``d``, divided as
``acc / (l + 1e-9)``; a destination with no valid edge emits zeros.  The
Hopper counterpart of the reference's one-pass Pallas kernel
(``src/repro/kernels/gat_fused.py:132``): one CUDA block per
destination, one warp per head, lanes across the head width, so edge
logits and alphas never reach device memory (``csrc/gat_fused.cu``).
Asked for ``stats``, the kernel also stores each destination's final
running max ``m`` and denominator ``l`` (num_dst, heads): one more store
per warp, no second pass.

Edge validity is carried by the dst-grouped layout
(:func:`repro_torch.kernels.segment_sum.dst_layout` with the edge mask):
masked edges are not listed, so neither version reads them.

:class:`GatAttention` is the differentiable op.  Its backward is the
closed form of the reference's ``_gat_bwd`` (``gat_fused.py:217``) with
the alphas recomputed elementwise from the saved ``(m, l)`` instead of by
segment max and sum: ``dhs`` is K1 over the src-grouped layout with an
(E, heads) coefficient (one launch for every head), ``dalpha`` is K6
with ``heads``, and the three per-destination and per-source sums are K2
launches.  No step uses a float atomic, so a training step is bitwise
repeatable on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_sum import (_check, _check_layout,
                                             _require_cuda, _segments,
                                             _stream)

NEG_INF = -1e30
LEAKY_SLOPE = 0.2
MAX_HEADS = 32          # one warp per head in a block of at most 1024

launches = {"gat_attention": 0}


def gat_attention_plain(hs: torch.Tensor, es: torch.Tensor,
                        ed: torch.Tensor, edge_src: torch.Tensor,
                        order: torch.Tensor, row_ptr: torch.Tensor,
                        num_dst: int, *, stats: bool = False):
    """Plain PyTorch K3 over the dst-grouped layout: per-destination max,
    exponentials, denominator and weighted sum as whole-tensor ops.  With
    ``stats`` returns ``(out, m, l)``: the max (``NEG_INF`` where no edge
    arrives) and the denominator, each (num_dst, heads)."""
    heads = es.shape[1]
    hd = hs.shape[1] // heads
    e = order.long()
    seg = _segments(row_ptr, num_dst)
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
    out = (acc / (den[..., None] + 1e-9)).reshape(num_dst, heads * hd)
    return (out, m, den) if stats else out


def gat_attention_cuda(hs: torch.Tensor, es: torch.Tensor, ed: torch.Tensor,
                       edge_src: torch.Tensor, order: torch.Tensor,
                       row_ptr: torch.Tensor, num_dst: int, *,
                       stats: bool = False):
    """K3 on the card (``csrc/gat_fused.cu``, ``gat_forward``)."""
    dev = _require_cuda(hs, "gat_attention_cuda")
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
    hd = hs.shape[1] // heads
    out = torch.empty((num_dst, heads * hd), dtype=torch.float32,
                      device=dev)
    m = l = None
    if stats:
        m = torch.empty((num_dst, heads), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
    if num_dst == 0:
        return (out, m, l) if stats else out
    lib = build.library("gat_fused")
    build.check(lib.gat_forward(
        hs.data_ptr(), es.data_ptr(), ed.data_ptr(), edge_src.data_ptr(),
        order.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
        m.data_ptr() if stats else None, l.data_ptr() if stats else None,
        num_dst, heads, hd, _stream()), "gat_forward")
    launches["gat_attention"] += 1
    return (out, m, l) if stats else out


def gat_attention_backward(g, hs, es, ed, m, l, edge_src, edge_dst,
                           edge_mask, order, row_ptr, src_layout):
    """Cotangents ``(dhs, des, ded)`` of K3 from the output cotangent
    ``g`` and the forward's ``(m, l)``, through :mod:`ops` (kernels on
    the card, plain versions on the CPU).  Not a kernel of its own: on
    the card it launches K1 over the src layout, K6 and K2 three times,
    each counted by its own wrapper.  ``order``/``row_ptr`` and
    ``src_layout`` must list exactly the edges ``edge_mask`` sets (as
    :class:`~repro_torch.core.abstraction.DeviceGraph` builds them)."""
    from repro_torch.kernels import ops
    S, D, heads = hs.shape[0], ed.shape[0], es.shape[1]
    order_s, row_ptr_s = src_layout
    src, dst = edge_src.long(), edge_dst.long()
    pre = es[src] + ed[dst]                                   # (E, H)
    z = torch.where(pre >= 0, pre, LEAKY_SLOPE * pre)
    alpha = torch.exp(z - m[dst]) / (l[dst] + 1e-9)
    alpha = torch.where(edge_mask[:, None], alpha, 0.0).contiguous()
    # transpose of "gather src, weight by alpha, scatter to dst": K1 over
    # the src-grouped layout, gathering g through edge_dst, all heads
    dhs = ops.gather_scale_segment_sum(g, edge_dst, alpha, order_s,
                                       row_ptr_s, S, transpose=True)
    dalpha = ops.edge_dot(hs, g, edge_src, edge_dst, order, heads)
    # closed-form softmax backward: dz = alpha * (dalpha - sum_dst)
    s = ops.segment_sum((alpha * dalpha).contiguous(), order, row_ptr, D)
    dz = alpha * (dalpha - s[dst])
    dpre = (dz * torch.where(pre >= 0, 1.0, LEAKY_SLOPE)).contiguous()
    ded = ops.segment_sum(dpre, order, row_ptr, D)
    des = ops.segment_sum(dpre, order_s, row_ptr_s, S)
    return dhs, des, ded


class GatAttention(torch.autograd.Function):
    """K3 with its VJP (:func:`gat_attention_backward`).  The forward
    keeps ``(m, l)`` only when a gradient is asked for."""

    @staticmethod
    def forward(ctx, hs, es, ed, edge_src, edge_dst, edge_mask, order,
                row_ptr, src_layout, num_dst):
        from repro_torch.kernels import ops
        if not any(ctx.needs_input_grad[:3]):
            return ops.gat_attention(hs, es, ed, edge_src, order, row_ptr,
                                     num_dst)
        if src_layout is None:
            raise ValueError(
                "gat_attention needs the src-grouped layout to "
                "differentiate: build the DeviceGraph with src_layout=True")
        out, m, l = ops.gat_attention(hs, es, ed, edge_src, order, row_ptr,
                                      num_dst, stats=True)
        ctx.src_layout = src_layout
        ctx.save_for_backward(hs, es, ed, m, l, edge_src, edge_dst,
                              edge_mask, order, row_ptr)
        return out

    @staticmethod
    def backward(ctx, g):
        dhs, des, ded = gat_attention_backward(
            g.contiguous(), *ctx.saved_tensors, ctx.src_layout)
        return dhs, des, ded, None, None, None, None, None, None, None
