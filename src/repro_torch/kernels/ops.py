"""Device dispatch for the aggregation kernels.

Each entry point looks at the device of its first tensor: a CUDA tensor
goes to the hand-written Hopper kernel, a CPU tensor to the kernel's
plain PyTorch version, anything else raises.  Nothing falls back: a
build or launch failure on the card is an error.

The reference's TPU capacity dispatch (``fused_fits``, ``VMEM_BUDGET``
and the unfused / multi-pass fallbacks) has no counterpart here: the
Hopper kernels' working set does not grow with ``num_src``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gat_fused as _gat
from repro_torch.kernels import segment_sum as _ss


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no aggregation kernel for device {t.device}")


def gather_scale_segment_sum(h, edge_src, coef, order, row_ptr,
                             num_dst: int):
    """K1: ``out[d] = sum_{e in d's range} coef[e] * h[edge_src[e]]``."""
    fn = (_ss.gather_scale_segment_sum_cuda if _on_cuda(h)
          else _ss.gather_scale_segment_sum_plain)
    return fn(h, edge_src, coef, order, row_ptr, num_dst)


def segment_sum(msgs, order, row_ptr, num_dst: int):
    """K2: ``out[d] = sum_{e in d's range} msgs[e]``."""
    fn = _ss.segment_sum_cuda if _on_cuda(msgs) else _ss.segment_sum_plain
    return fn(msgs, order, row_ptr, num_dst)


def gat_attention(hs, es, ed, edge_src, order, row_ptr, num_dst: int):
    """K3: one-pass per-destination attention softmax and weighted sum."""
    fn = _gat.gat_attention_cuda if _on_cuda(hs) else _gat.gat_attention_plain
    return fn(hs, es, ed, edge_src, order, row_ptr, num_dst)


def launch_counts() -> dict:
    """Launches of every kernel wrapper since the last reset."""
    return {**_ss.launches, **_gat.launches}


def reset_launch_counts() -> None:
    for counts in (_ss.launches, _gat.launches):
        for k in counts:
            counts[k] = 0
