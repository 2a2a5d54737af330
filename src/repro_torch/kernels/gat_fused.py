"""One-pass fused GAT attention aggregation (K3), its VJP, and their plain
versions.

``out[d, h] = sum_e softmax_d(leaky_relu(es[src_e, h] + ed[d, h], 0.2))_e
· hs[src_e, h]`` over the valid edges into ``d``, divided as
``acc / (l + 1e-9)``; a destination with no valid edge emits zeros.  The
Hopper counterpart of the reference's one-pass Pallas kernel
(``src/repro/kernels/gat_fused.py:132``): a group of lanes per
destination covers its whole row of heads, walks its edges once with an
online softmax, and keeps edge logits and alphas out of device memory
(``csrc/gat_fused.cu``).  Asked for ``stats``, the kernel also stores
each destination's final running max ``m`` and denominator ``l``
(num_dst, heads).

Edge validity is carried by the dst-grouped layout
(:func:`repro_torch.kernels.segment_sum.dst_layout` with the edge mask):
masked edges are not listed, so neither version reads them.

:class:`GatAttention` is the differentiable op.  Its backward is the
closed form of the reference's ``_gat_bwd`` (``gat_fused.py:217``) with
the alphas recomputed from the saved ``(m, l)``, in two passes: the
destination pass (:func:`gat_backward_dst_cuda`, a kernel of its own)
takes ``dalpha = <g[d], hs[src]>`` per head, the per-destination sum
``s = sum alpha dalpha``, ``dpre`` and ``ded`` in one walk of each
destination's edges, and writes ``alpha`` and ``dpre``; the source pass is
K1 over the src-grouped layout, which sums ``alpha · g[dst]`` into
``dhs`` and ``dpre`` into ``des`` in the same walk.  No step uses a float
atomic, so a training step is bitwise repeatable on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_sum import (_align, _check, _check_layout,
                                             _edge_output, _floats_per_lane,
                                             _refuse_grad, _require_cuda,
                                             _segments, _stream, lane_plan)

NEG_INF = -1e30
LEAKY_SLOPE = 0.2
MAX_HEADS = 32          # each head takes at least one lane of a warp
MAX_VPL = 8             # vectors a lane holds (the kernels' template range)

launches = {"gat_attention": 0, "gat_attention_backward": 0}


def _check_gat(hs, es, ed, edge_src, order, row_ptr, num_dst, dev) -> None:
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


def _logits(es, ed, edge_src, order, row_ptr, num_dst):
    """The listed edges' sources, destinations and ``pre`` and ``z``."""
    e = order.long()
    seg = _segments(row_ptr, num_dst)
    src = edge_src.long()[e]
    pre = es[src] + ed[seg]                                   # (nnz, H)
    return e, seg, src, pre, torch.where(pre >= 0, pre, LEAKY_SLOPE * pre)


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
    _, seg, src, _, z = _logits(es, ed, edge_src, order, row_ptr, num_dst)
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
    _refuse_grad("gat_attention_cuda (K3)", "kernels.gat_fused.GatAttention",
                 hs, es, ed)
    _check_gat(hs, es, ed, edge_src, order, row_ptr, num_dst, dev)
    heads = es.shape[1]
    hd = hs.shape[1] // heads
    out = torch.empty((num_dst, heads * hd), dtype=torch.float32,
                      device=dev)
    m = l = None
    if stats:
        m = torch.empty((num_dst, heads), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
    if num_dst == 0:
        return (out, m, l) if stats else out
    plan = lane_plan(heads, hd, _align(hs, out), _floats_per_lane(num_dst),
                     max_vpl=MAX_VPL)
    lib = build.library("gat_fused")
    build.check(lib.gat_forward(
        hs.data_ptr(), es.data_ptr(), ed.data_ptr(), edge_src.data_ptr(),
        order.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
        m.data_ptr() if stats else None, l.data_ptr() if stats else None,
        num_dst, heads, hd, plan["vec"], plan["hpg"], plan["lph"],
        plan["vpl"], plan["group"], _stream()), "gat_forward")
    launches["gat_attention"] += 1
    return (out, m, l) if stats else out


def gat_backward_dst_plain(g, hs, es, ed, m, l, edge_src, order, row_ptr,
                           num_edges: int):
    """Plain PyTorch destination pass of K3's VJP: ``(alpha, dpre, ded)``,
    the first two (num_edges, heads) and zero on the edges the layout
    does not list, ``ded`` (num_dst, heads)."""
    heads, D = es.shape[1], ed.shape[0]
    hd = hs.shape[1] // heads
    e, seg, src, pre, z = _logits(es, ed, edge_src, order, row_ptr, D)
    a = torch.exp(z - m[seg]) / (l[seg] + 1e-9)
    dalpha = (hs.reshape(-1, heads, hd)[src]
              * g.reshape(-1, heads, hd)[seg]).sum(-1)
    zeros = torch.zeros((D, heads), dtype=hs.dtype, device=hs.device)
    # closed-form softmax backward: dz = alpha * (dalpha - sum_dst)
    s = zeros.index_add(0, seg, a * dalpha)
    dp = a * (dalpha - s[seg]) * torch.where(pre >= 0, 1.0, LEAKY_SLOPE)
    edge = torch.zeros((num_edges, heads), dtype=hs.dtype, device=hs.device)
    return (edge.index_copy(0, e, a), edge.index_copy(0, e, dp),
            zeros.index_add(0, seg, dp))


def gat_backward_dst_cuda(g, hs, es, ed, m, l, edge_src, order, row_ptr,
                          num_edges: int):
    """The destination pass of K3's VJP on the card (``csrc/gat_fused.cu``,
    ``gat_backward_dst``), counted under ``gat_attention_backward``."""
    dev = _require_cuda(hs, "gat_backward_dst_cuda")
    _refuse_grad("gat_backward_dst_cuda (K3's VJP, no double backward)",
                 None, g, hs, es, ed, m, l)
    D = ed.shape[0]
    _check_gat(hs, es, ed, edge_src, order, row_ptr, D, dev)
    heads = es.shape[1]
    hd = hs.shape[1] // heads
    _check(g, "g", torch.float32, 2, dev)
    for t, name in ((m, "m"), (l, "l")):
        _check(t, name, torch.float32, 2, dev)
    if (tuple(g.shape) != (D, heads * hd)
            or tuple(m.shape) != (D, heads) or tuple(l.shape) != (D, heads)):
        raise ValueError(f"g {tuple(g.shape)}, m {tuple(m.shape)} and l "
                         f"{tuple(l.shape)} do not match {D} destinations "
                         f"of {heads} x {hd}")
    if edge_src.shape[0] != num_edges or order.shape[0] > num_edges:
        raise ValueError("edge_src and order do not match num_edges")
    nnz = order.shape[0]
    alpha = _edge_output(nnz, (num_edges, heads), dev)
    dpre = _edge_output(nnz, (num_edges, heads), dev)
    ded = torch.empty((D, heads), dtype=torch.float32, device=dev)
    if D == 0:
        return alpha, dpre, ded
    plan = lane_plan(heads, hd, _align(g, hs), _floats_per_lane(D),
                     max_vpl=MAX_VPL)
    lib = build.library("gat_fused")
    build.check(lib.gat_backward_dst(
        g.data_ptr(), hs.data_ptr(), es.data_ptr(), ed.data_ptr(),
        m.data_ptr(), l.data_ptr(), edge_src.data_ptr(), order.data_ptr(),
        row_ptr.data_ptr(), alpha.data_ptr(), dpre.data_ptr(),
        ded.data_ptr(), D, heads, hd, plan["vec"], plan["hpg"], plan["lph"],
        plan["vpl"], plan["group"], _stream()), "gat_backward_dst")
    launches["gat_attention_backward"] += 1
    return alpha, dpre, ded


def gat_attention_backward(g, hs, es, ed, m, l, edge_src, edge_dst, order,
                           row_ptr, src_layout):
    """Cotangents ``(dhs, des, ded)`` of K3 from the output cotangent
    ``g`` and the forward's ``(m, l)``, through :mod:`ops` (kernels on
    the card, plain versions on the CPU): the destination pass, then K1
    over the src-grouped layout with ``alpha`` as coefficient and ``dpre``
    as the column it also sums.  ``order``/``row_ptr`` and ``src_layout``
    list the same (valid) edges, as
    :class:`~repro_torch.core.abstraction.DeviceGraph` builds them."""
    from repro_torch.kernels import ops
    alpha, dpre, ded = ops.gat_backward_dst(g, hs, es, ed, m, l, edge_src,
                                            order, row_ptr,
                                            edge_src.shape[0])
    # transpose of "gather src, weight by alpha, scatter to dst": K1 over
    # the src-grouped layout, gathering g through edge_dst, all heads
    order_s, row_ptr_s = src_layout
    dhs, des = ops.gather_scale_segment_sum(g, edge_dst, alpha, order_s,
                                            row_ptr_s, hs.shape[0],
                                            transpose=True, col=dpre)
    return dhs, des, ded


class GatAttention(torch.autograd.Function):
    """K3 with its VJP (:func:`gat_attention_backward`).  The forward
    keeps ``(m, l)`` only when a gradient is asked for."""

    @staticmethod
    def forward(ctx, hs, es, ed, edge_src, edge_dst, order, row_ptr,
                src_layout, num_dst):
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
        ctx.save_for_backward(hs, es, ed, m, l, edge_src, edge_dst, order,
                              row_ptr)
        return out

    @staticmethod
    def backward(ctx, g):
        dhs, des, ded = gat_attention_backward(
            g.contiguous(), *ctx.saved_tensors, ctx.src_layout)
        return dhs, des, ded, None, None, None, None, None, None
