"""Programming abstractions for GNNs (survey §3.2.3, Table 5), in PyTorch.

* **SAGA-NN** (NeuGraph): a GNN layer is Scatter → ApplyEdge → Gather →
  ApplyVertex.  Scatter/Gather are system-provided; ApplyEdge and
  ApplyVertex are user-defined tensor functions.
* a **message-passing base class** (DGL/PyG style) on top of SAGA-NN,
  used by the model zoo.

The Gather step runs over a dst-grouped layout (``order``, ``row_ptr``)
that :class:`DeviceGraph` builds once per graph or block on the host;
trainers also ask for the src-grouped layout, which the transposes in
the backward walk.  :mod:`repro_torch.kernels.ops` sends both to the
hand-written Hopper kernels for CUDA tensors and to their plain versions
for CPU tensors; the reference's ``use_kernel`` switch has no
counterpart here.  Every reduction, forward or backward, is a kernel
with one writer per output row: no float atomics, so a training step is
bitwise repeatable on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core.comm import QuantizedRows
from repro_torch.core.sampling import Block
from repro_torch.graph.structure import Graph
from repro_torch.kernels import ops as kops
from repro_torch.kernels.segment_sum import Layout, dst_layout


def _to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class DeviceGraph:
    """Padded edge-list graph on a device, plus its dst-grouped layout.

    For bipartite blocks ``num_dst != num_src`` and destination nodes are
    a prefix of source nodes.  ``order`` lists the valid edges stably
    sorted by destination and ``row_ptr`` (num_dst + 1, int32) delimits
    each destination's range; both are built on the host with numpy, as
    are the degrees (integer counts of valid edges, so exact).  Built
    with ``src_layout=True`` it also holds the same edges grouped by
    source (``order_src``, ``row_ptr_src`` over ``num_src``), which a
    gradient with respect to source rows needs; serving leaves them
    None."""
    edge_src: torch.Tensor     # (E,) int32 — index into src features
    edge_dst: torch.Tensor     # (E,) int32 — index into dst features
    edge_mask: torch.Tensor    # (E,) bool
    num_src: int
    num_dst: int
    in_deg: torch.Tensor       # (num_dst,) float32 (masked in-degree, >= 1)
    out_deg: torch.Tensor      # (num_src,) float32 (>= 1)
    order: torch.Tensor        # (nnz,) int32
    row_ptr: torch.Tensor      # (num_dst + 1,) int32
    order_src: Optional[torch.Tensor] = None     # (nnz,) int32
    row_ptr_src: Optional[torch.Tensor] = None   # (num_src + 1,) int32

    @property
    def layout(self) -> Layout:
        return self.order, self.row_ptr

    @property
    def src_layout(self) -> Optional[Layout]:
        if self.order_src is None:
            return None
        return self.order_src, self.row_ptr_src

    @staticmethod
    def _build(es: np.ndarray, ed: np.ndarray, mask: np.ndarray,
               num_src: int, num_dst: int,
               device: Union[str, torch.device],
               src_layout: bool) -> "DeviceGraph":
        device = torch.device(device)
        es = es.astype(np.int32)
        ed = ed.astype(np.int32)
        mask = mask.astype(bool)
        # the kernels gather with these indices unchecked: validate here,
        # on the host, once per block
        if len(es) and (es.min() < 0 or es.max() >= num_src
                        or ed.min() < 0 or ed.max() >= num_dst):
            raise ValueError(f"edge indices out of range for {num_src} "
                             f"sources and {num_dst} destinations")
        order, row_ptr = dst_layout(ed, num_dst, mask)
        indeg = np.maximum(np.diff(row_ptr), 1).astype(np.float32)
        outdeg = np.maximum(np.bincount(es[mask], minlength=num_src),
                            1).astype(np.float32)
        by_src = (tuple(_to(a, device) for a in dst_layout(es, num_src, mask))
                  if src_layout else (None, None))
        return DeviceGraph(_to(es, device), _to(ed, device),
                           _to(mask, device), num_src, num_dst,
                           _to(indeg, device), _to(outdeg, device),
                           _to(order, device), _to(row_ptr, device),
                           *by_src)

    @staticmethod
    def from_graph(g: Graph, device: Union[str, torch.device], *,
                   src_layout: bool = False) -> "DeviceGraph":
        e = g.edges()
        n = g.num_nodes
        return DeviceGraph._build(e[:, 0], e[:, 1], np.ones(len(e), bool),
                                  n, n, device, src_layout)

    @staticmethod
    def from_block(b: Block, device: Union[str, torch.device], *,
                   src_layout: bool = False) -> "DeviceGraph":
        return DeviceGraph._build(np.asarray(b.edge_src),
                                  np.asarray(b.edge_dst),
                                  np.asarray(b.edge_mask), b.num_src,
                                  b.num_dst, device, src_layout)


# ---------------------------------------------------------------------------
# segment reductions (the Gather step)
# ---------------------------------------------------------------------------

def segment_sum(msgs: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int, *, layout: Layout) -> torch.Tensor:
    """Gather-step segment reduction over ``layout``, the dst-grouped
    ``(order, row_ptr)`` of ``seg_ids`` (``DeviceGraph.layout``).  1-D
    messages (per-edge scalars) are reduced as one column.  Its backward
    gathers the cotangent rows back onto the listed edges (K5)."""
    order, row_ptr = layout
    seg_ids = seg_ids.to(torch.int32)
    if msgs.dim() == 1:
        return kops.SegmentSum.apply(msgs[:, None].contiguous(), seg_ids,
                                     order, row_ptr, num_segments)[:, 0]
    return kops.SegmentSum.apply(msgs.contiguous(), seg_ids, order, row_ptr,
                                 num_segments)


def gather_scale_segment_sum(h, edge_src: torch.Tensor,
                             edge_dst: torch.Tensor, coef: torch.Tensor,
                             num_dst: int, *, layout: Layout,
                             src_layout: Optional[Layout] = None
                             ) -> torch.Tensor:
    """Fused Scatter -> ApplyEdge(scale) -> Gather:
    ``out[d] = sum_{e: edge_dst[e]=d} coef[e] * h[edge_src[e]]``.

    ``coef`` is the per-edge coefficient with the validity mask folded in
    (masked/pad edges carry 0).  On a CUDA tensor this is one kernel that
    never materializes the (E, F) message tensor.  A gradient with
    respect to ``h`` runs the same kernel over ``src_layout`` (the
    src-grouped layout of the same edges); one with respect to ``coef``
    runs the edge-dot kernel.  ``QuantizedRows`` (int8 wire rows, which
    carry no gradient) go to the int8-in kernel as they are: ``q``,
    ``mn`` and ``scale`` are uploaded and dequantized in registers, with
    no decoded copy of the rows."""
    order, row_ptr = layout
    if isinstance(h, QuantizedRows):
        dev = edge_src.device
        return kops.gather_scale_segment_sum_q(
            _to(h.q, dev), _to(h.mn, dev), _to(h.scale, dev), edge_src,
            coef.contiguous(), order, row_ptr, num_dst)
    return kops.GatherScaleSegmentSum.apply(
        h.contiguous(), edge_src, edge_dst, coef.contiguous(), order,
        row_ptr, src_layout, num_dst)


def segment_mean(msgs: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int, deg: torch.Tensor, *,
                 layout: Layout) -> torch.Tensor:
    """Degree-normalized segment reduction."""
    s = segment_sum(msgs, seg_ids, num_segments, layout=layout)
    return s / deg[:, None]


def segment_max(msgs: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; empty segments come out ``-inf`` (as
    ``jax.ops.segment_max`` gives them)."""
    out = torch.full((num_segments,) + tuple(msgs.shape[1:]), -torch.inf,
                     dtype=msgs.dtype, device=msgs.device)
    idx = seg_ids.long().reshape((-1,) + (1,) * (msgs.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(msgs), msgs, "amax")


def segment_softmax(logits: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int, mask: torch.Tensor, *,
                    layout: Layout) -> torch.Tensor:
    """Per-destination softmax over incoming edges (GAT's multi-pass
    form; the model itself runs the one-pass kernel)."""
    m = mask[:, None] if logits.dim() > 1 else mask
    logits = torch.where(m, logits, torch.full_like(logits, -1e30))
    mx = segment_max(logits, seg_ids, num_segments)
    ex = torch.exp(logits - mx[seg_ids.long()])
    ex = ex * m.to(ex.dtype)
    den = segment_sum(ex, seg_ids, num_segments, layout=layout)
    return ex / (den[seg_ids.long()] + 1e-9)


# ---------------------------------------------------------------------------
# SAGA-NN
# ---------------------------------------------------------------------------

def saga_layer(g: DeviceGraph, x_src: torch.Tensor, x_dst: torch.Tensor, *,
               apply_edge: Callable, gather: str = "sum",
               apply_vertex: Callable,
               edge_data: Optional[torch.Tensor] = None,
               reads_dst: bool = True) -> torch.Tensor:
    """One SAGA-NN step.

    scatter:      src features -> edges (system)
    apply_edge:   (src_feat_on_edge, dst_feat_on_edge, edge_data) -> msgs
    gather:       segment reduce msgs onto destinations (system)
    apply_vertex: (aggregated, x_dst) -> new dst features

    With ``reads_dst=False`` the destination rows are not scattered onto
    the edges and ``apply_edge`` gets None for them: eager PyTorch does
    not drop an (E, F) gather that nothing reads, as XLA does.
    """
    # Scatter: rows onto the listed edges (K5); the transposes are K2
    # over the layout grouped by the gathering index
    feat_e = kops.GatherRows.apply(x_src.contiguous(), g.edge_src, g.order,
                                   g.src_layout)
    dst_e = (kops.GatherRows.apply(x_dst.contiguous(), g.edge_dst, g.order,
                                   g.layout) if reads_dst else None)
    msgs = apply_edge(feat_e, dst_e, edge_data)                # ApplyEdge
    msgs = msgs * g.edge_mask[:, None].to(msgs.dtype)
    if gather == "sum":                                        # Gather
        agg = segment_sum(msgs, g.edge_dst, g.num_dst, layout=g.layout)
    elif gather == "mean":
        agg = segment_mean(msgs, g.edge_dst, g.num_dst, g.in_deg,
                           layout=g.layout)
    elif gather == "max":
        agg = segment_max(msgs, g.edge_dst, g.num_dst)
        agg = torch.where(torch.isfinite(agg), agg, torch.zeros_like(agg))
    else:
        raise ValueError(gather)
    return apply_vertex(agg, x_dst)                            # ApplyVertex


def dequantize_on(x, device: torch.device) -> torch.Tensor:
    """``QuantizedRows`` decoded onto ``device``; tensors pass through."""
    if isinstance(x, QuantizedRows):
        return _to(x.dequantize(), device)
    return x


class MessagePassing(nn.Module):
    """DGL/PyG-style base class on top of SAGA-NN.  Subclasses override
    ``message``/``aggregate``/``update`` and hold their parameters."""

    aggregate = "sum"
    #: whether ``message`` reads ``dst_feat``; a subclass whose message
    #: does sets it, else the Scatter step passes None
    message_reads_dst = False

    def message(self, src_feat, dst_feat, edge_data):
        return src_feat

    def update(self, agg, self_feat):
        raise NotImplementedError

    def forward(self, g: DeviceGraph, x_src, x_dst=None):
        # generic layers scatter fp32 rows onto edges; only layers that
        # aggregate before projecting (SAGE) consume the wire format
        x_src = dequantize_on(x_src, g.edge_src.device)
        if x_dst is None:
            x_dst = x_src[:g.num_dst]
        return saga_layer(g, x_src, x_dst, apply_edge=self.message,
                          gather=self.aggregate, apply_vertex=self.update,
                          reads_dst=self.message_reads_dst)
