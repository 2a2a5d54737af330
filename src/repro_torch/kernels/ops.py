"""Device dispatch for the hand-written kernels (the aggregations K1-K6,
K3's VJP, flash attention K7, the SSD chunk state K8, and K7's and K8's
VJPs), and the differentiable entry points built on them.

Each kernel entry point looks at the device of its first tensor: a CUDA
tensor goes to the hand-written Hopper kernel, a CPU tensor to the
kernel's plain PyTorch version, anything else raises.  Nothing falls
back: a build or launch failure on the card is an error.

The autograd Functions (:class:`GatherScaleSegmentSum`,
:class:`SegmentSum`, :class:`GatherRows`, :class:`GatAttention`) call
these entry points in their forward and backward, so the same backward
formulas run on both devices.  K7 and K8 on the card go through their
own Functions (``FlashAttention``, ``SSDChunkState``) where autograd
records the call; on the CPU their plain versions are differentiable as
they stand.

The reference's TPU capacity dispatch (``fused_fits``, ``VMEM_BUDGET``
and the unfused / multi-pass fallbacks) has no counterpart here: the
Hopper kernels' working set does not grow with ``num_src``.
"""
from __future__ import annotations

import functools

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gat_fused as _gat
from repro_torch.kernels import segment_sum as _ss
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels.gat_fused import GatAttention  # noqa: F401
from repro_torch.kernels.segment_sum import (  # noqa: F401
    GatherRows, GatherScaleSegmentSum, SegmentSum)


def gather_scale_segment_sum(h, edge_src, coef, order, row_ptr,
                             num_dst: int, *, transpose: bool = False,
                             col=None):
    """K1: ``out[d] = sum_{e in d's range} coef[e] * h[edge_src[e]]``
    (``coef`` (E,) or (E, heads)); ``transpose`` marks a launch over the
    src-grouped layout from a backward, which the kernel wrapper counts
    apart.  With ``col`` (E, heads), returns ``(out, col_out)``: also the
    per-head sum of ``col`` over each range, from the same walk."""
    fn = _ss.pick(functools.partial(_ss.gather_scale_segment_sum_cuda,
                                    transpose=transpose),
                  _ss.gather_scale_segment_sum_plain, h)
    return fn(h, edge_src, coef, order, row_ptr, num_dst, col=col)


def segment_sum(msgs, order, row_ptr, num_dst: int):
    """K2: ``out[d] = sum_{e in d's range} msgs[e]``."""
    fn = _ss.pick(_ss.segment_sum_cuda, _ss.segment_sum_plain, msgs)
    return fn(msgs, order, row_ptr, num_dst)


def gat_attention(hs, es, ed, edge_src, order, row_ptr, num_dst: int, *,
                  stats: bool = False):
    """K3: one-pass per-destination attention softmax and weighted sum;
    with ``stats`` also the per-destination max and denominator."""
    fn = _ss.pick(_gat.gat_attention_cuda, _gat.gat_attention_plain, hs)
    return fn(hs, es, ed, edge_src, order, row_ptr, num_dst, stats=stats)


def gat_backward_dst(g, hs, es, ed, m, l, edge_src, order, row_ptr,
                     num_edges: int):
    """The destination pass of K3's VJP: ``(alpha, dpre, ded)`` from the
    output cotangent and the forward's ``(m, l)``."""
    fn = _ss.pick(_gat.gat_backward_dst_cuda, _gat.gat_backward_dst_plain,
                  hs)
    return fn(g, hs, es, ed, m, l, edge_src, order, row_ptr, num_edges)


def gather_scale_segment_sum_q(q, mn, scale, edge_src, coef, order,
                               row_ptr, num_dst: int):
    """K4: K1 on uint8 rows ``mn + q * scale``, dequantized in the
    kernel; forward only (the wire rows carry no gradient)."""
    fn = _ss.pick(_ss.gather_scale_segment_sum_q_cuda,
                  _ss.gather_scale_segment_sum_q_plain, q)
    return fn(q, mn, scale, edge_src, coef, order, row_ptr, num_dst)


def gather_rows(g, seg, order, num_edges: int):
    """K5: ``out[e] = g[seg[e]]`` on the listed edges, zero elsewhere."""
    fn = _ss.pick(_ss.gather_rows_cuda, _ss.gather_rows_plain, g)
    return fn(g, seg, order, num_edges)


def edge_dot(a, b, edge_src, order, row_ptr, heads: int = 1):
    """K6: ``out[e, h] = <a[src_e], b[d]>`` over head ``h``'s columns for
    each edge listed in destination ``d``'s range of the dst-grouped
    layout ``(order, row_ptr)``, zero elsewhere; (E, heads)."""
    fn = _ss.pick(_ss.edge_dot_cuda, _ss.edge_dot_plain, a)
    return fn(a, b, edge_src, order, row_ptr, heads)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None):
    """K7: causal / sliding-window / non-causal GQA attention, queries
    aligned to the end of the kv axis (where a mask reads it); q (B, H,
    Sq, hd), k (B, K, Skv, hd), v (B, K, Skv, hd_v) -> (B, H, Sq, hd_v).
    Differentiable on both devices: on the card through
    ``FlashAttention`` (K7 with its lse, then the backward kernels) when
    autograd records the call, else the forward alone."""
    fn = _ss.pick(_fa.flash_attention_card, _fa.flash_attention_plain, q)
    return fn(q, k, v, causal=causal, window=window, scale=scale)


def ssd_chunk_state(x, dt, A, Bm):
    """K8: the Mamba2 SSD per-chunk state (C, H, P, N) in float32.
    Differentiable on both devices, as K7 (``SSDChunkState``)."""
    fn = _ss.pick(_ssd.ssd_chunk_state_card, _ssd.ssd_chunk_state_plain, x)
    return fn(x, dt, A, Bm)


_COUNTS = (_ss.launches, _gat.launches, _fa.launches, _ssd.launches)


def launch_counts() -> dict:
    """Launches of every kernel wrapper since the last reset."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def launch_counts_by_width() -> dict:
    """K1's launches since the last reset by counter and row width:
    ``{counter: {F: n}}``."""
    out: dict = {}
    for (name, width), n in sorted(_ss.launches_by_width.items()):
        out.setdefault(name, {})[width] = n
    return out


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0
    _ss.launches_by_width.clear()
