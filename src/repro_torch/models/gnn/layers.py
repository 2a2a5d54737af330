"""GNN layers built on the SAGA-NN / message-passing abstraction
(survey Table 5 algorithms: GCN, GraphSAGE, GAT, GIN, GGNN, APPNP).

Each layer is an ``nn.Module`` whose parameter names are the reference's
param-dict keys (``w``, ``b``, ``w_self``, ...), made on an explicit
device and initialized from an explicit ``torch.Generator``.  The
generator does not reproduce JAX's numbers; weights that must match the
reference come through :func:`repro_torch.models.gnn.model.params_from_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.abstraction import (DeviceGraph, MessagePassing,
                                          dequantize_on,
                                          gather_scale_segment_sum)
from repro_torch.core.comm import QuantizedRows
from repro_torch.kernels import ops as kops


def _dense(din: int, dout: int, gen: torch.Generator,
           device: torch.device) -> nn.Parameter:
    w = torch.randn((din, dout), generator=gen, dtype=torch.float32)
    return nn.Parameter((w / np.sqrt(din)).to(device))


def _zeros(shape, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device))


class GCNLayer(MessagePassing):
    """Kipf & Welling: h' = D^-1/2 A D^-1/2 H W + b."""

    aggregate = "sum"

    def __init__(self, din: int, dout: int, *, device,
                 gen: torch.Generator):
        super().__init__()
        self.w = _dense(din, dout, gen, device)
        self.b = _zeros((dout,), device)

    def forward(self, g: DeviceGraph, x_src, x_dst=None):
        x_src = dequantize_on(x_src, g.edge_src.device)   # projects first
        h = x_src @ self.w
        norm_src = torch.rsqrt(g.out_deg)
        norm_dst = torch.rsqrt(g.in_deg)
        coef = norm_src[g.edge_src.long()] * norm_dst[g.edge_dst.long()]
        # fused gather+scale+reduce: the (E, F) message tensor never
        # exists on the kernel path
        agg = gather_scale_segment_sum(h, g.edge_src, g.edge_dst,
                                       coef * g.edge_mask, g.num_dst,
                                       layout=g.layout,
                                       src_layout=g.src_layout)
        return agg + self.b


class SAGELayer(MessagePassing):
    """GraphSAGE-mean: h' = W_self h + W_nbr mean(neighbors).

    The neighbor mean routes through the fused gather→scale→segment-sum
    (mask as the per-edge coefficient, degree normalization after).
    Features aggregate before any projection, so layer 0 takes
    ``QuantizedRows`` (int8 wire rows) as they are: the aggregation runs
    the int8-in kernel on the uploaded codes, and the self path decodes
    only the ``num_dst`` prefix, on the device."""

    aggregate = "mean"

    def __init__(self, din: int, dout: int, *, device,
                 gen: torch.Generator):
        super().__init__()
        self.w_self = _dense(din, dout, gen, device)
        self.w_nbr = _dense(din, dout, gen, device)
        self.b = _zeros((dout,), device)

    def update(self, agg, self_feat):
        return self_feat @ self.w_self + agg @ self.w_nbr + self.b

    def forward(self, g: DeviceGraph, x_src, x_dst=None):
        if x_dst is None:
            # the self path needs fp32 rows: only the num_dst prefix of
            # wire-format rows is decoded for it (the codec's arithmetic)
            if isinstance(x_src, QuantizedRows):
                q, mn, scale = (torch.from_numpy(np.ascontiguousarray(
                    a[:g.num_dst])).to(g.edge_src.device) for a in x_src)
                x_dst = mn + q.to(torch.float32) * scale
            else:
                x_dst = x_src[:g.num_dst]
        coef = g.edge_mask.to(torch.float32)
        agg = gather_scale_segment_sum(x_src, g.edge_src, g.edge_dst, coef,
                                       g.num_dst, layout=g.layout,
                                       src_layout=g.src_layout)
        agg = agg / g.in_deg[:, None]
        return self.update(agg, x_dst)


class GATLayer(MessagePassing):
    """Single-projection multi-head GAT with per-destination softmax,
    aggregated by the one-pass attention kernel (K3)."""

    def __init__(self, din: int, dout: int, *, heads: int = 4, device,
                 gen: torch.Generator):
        super().__init__()
        hd = dout // heads
        self.w = _dense(din, dout, gen, device)
        self.a_src = nn.Parameter(
            (torch.randn((heads, hd), generator=gen) * 0.1).to(device))
        self.a_dst = nn.Parameter(
            (torch.randn((heads, hd), generator=gen) * 0.1).to(device))

    def forward(self, g: DeviceGraph, x_src, x_dst=None):
        # attention projects before aggregating: decode up front
        x_src = dequantize_on(x_src, g.edge_src.device)
        if x_dst is None:
            x_dst = x_src[:g.num_dst]
        heads, hd = self.a_src.shape
        hs = (x_src @ self.w).reshape(-1, heads, hd)
        hdst = (x_dst @ self.w).reshape(-1, heads, hd)
        es = torch.einsum("nhd,hd->nh", hs, self.a_src).contiguous()
        ed = torch.einsum("nhd,hd->nh", hdst, self.a_dst).contiguous()
        return kops.GatAttention.apply(
            hs.reshape(-1, heads * hd).contiguous(), es, ed, g.edge_src,
            g.edge_dst, g.order, g.row_ptr, g.src_layout,
            g.num_dst)


class GINLayer(MessagePassing):
    """GIN: h' = MLP((1 + eps) h + sum(neighbors)); the sum runs through
    ``saga_layer`` and the segment-sum kernel (K2)."""

    aggregate = "sum"

    def __init__(self, din: int, dout: int, *, device,
                 gen: torch.Generator):
        super().__init__()
        self.w1 = _dense(din, dout, gen, device)
        self.w2 = _dense(dout, dout, gen, device)
        self.b1 = _zeros((dout,), device)
        self.b2 = _zeros((dout,), device)
        self.eps = _zeros((), device)

    def update(self, agg, self_feat):
        h = (1.0 + self.eps) * self_feat + agg
        h = F.relu(h @ self.w1 + self.b1)
        return h @ self.w2 + self.b2


class GGNNLayer(MessagePassing):
    """Gated Graph NN [Li+ 2015]: GRU update over the aggregated neighbor
    messages; dimensions stay constant across layers (``proj`` maps the
    input width when it differs, and is None otherwise)."""

    aggregate = "sum"

    def __init__(self, din: int, dout: int, *, device,
                 gen: torch.Generator):
        super().__init__()
        self.w_msg = _dense(dout, dout, gen, device)
        self.w_zrh = _dense(dout, 3 * dout, gen, device)
        self.u_zrh = _dense(dout, 3 * dout, gen, device)
        self.proj = _dense(din, dout, gen, device) if din != dout else None
        self.b = _zeros((3 * dout,), device)

    def forward(self, g: DeviceGraph, x_src, x_dst=None):
        x_src = dequantize_on(x_src, g.edge_src.device)   # projects first
        if self.proj is not None:
            x_src = x_src @ self.proj
        if x_dst is None:
            x_dst = x_src[:g.num_dst]
        hm = x_src @ self.w_msg
        agg = gather_scale_segment_sum(hm, g.edge_src, g.edge_dst,
                                       g.edge_mask.to(hm.dtype), g.num_dst,
                                       layout=g.layout,
                                       src_layout=g.src_layout)
        d = x_dst.shape[-1]
        gates = agg @ self.w_zrh + x_dst @ self.u_zrh + self.b
        z = torch.sigmoid(gates[:, :d])
        r = torch.sigmoid(gates[:, d:2 * d])
        # candidate uses reset-gated state through the U path
        h_tilde = torch.tanh(agg @ self.w_zrh[:, 2 * d:]
                             + (r * x_dst) @ self.u_zrh[:, 2 * d:])
        return (1 - z) * x_dst + z * h_tilde


class APPNPLayer(MessagePassing):
    """APPNP [Klicpera+ 2019]: personalized-PageRank propagation
    h' = (1-α)·Â h + α·h0.  The module holds one MLP-head weight ``w``;
    :meth:`propagate` itself has no weights."""

    aggregate = "sum"

    def __init__(self, din: int, dout: int, *, alpha: float = 0.1, device,
                 gen: torch.Generator):
        super().__init__()
        self.alpha = alpha
        self.w = _dense(din, dout, gen, device)

    def propagate(self, g: DeviceGraph, h, h0):
        coef = (torch.rsqrt(g.out_deg)[g.edge_src.long()]
                * torch.rsqrt(g.in_deg)[g.edge_dst.long()] * g.edge_mask)
        agg = gather_scale_segment_sum(h, g.edge_src, g.edge_dst, coef,
                                       g.num_dst, layout=g.layout,
                                       src_layout=g.src_layout)
        return (1 - self.alpha) * agg + self.alpha * h0


LAYER_TYPES = {"gcn": GCNLayer, "sage": SAGELayer, "gat": GATLayer,
               "gin": GINLayer, "ggnn": GGNNLayer}
