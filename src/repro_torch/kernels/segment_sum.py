"""Edge-list aggregations over grouped layouts: the GNN Gather step, its
transposes, and the int8-in variant.

Five kernels, each with its plain PyTorch version beside it:

* :func:`gather_scale_segment_sum_cuda` (K1) —
  ``out[d] = sum_{e: dst_e=d} coef_e * h[src_e]`` without the (E, F)
  message tensor; the Hopper counterpart of the reference's fused Pallas
  kernel (``src/repro/kernels/segment_sum.py:320``).  Over the
  src-grouped layout, gathering through ``edge_dst``, the same kernel is
  its own transpose (``_fused_bwd`` ``:441``); a coefficient of shape
  (E, heads) weights each head's columns separately, and a column of the
  same shape is summed per head in the same walk (the GAT backward).
* :func:`segment_sum_cuda` (K2) — ``out[d] = sum_{e: seg_e=d} msgs[e]``;
  the counterpart of the blocked scatter (``segment_sum.py:138``).
* :func:`gather_rows_cuda` (K5) — ``out[e] = g[seg_e]``, the transpose of
  K2 (``gather_rows_pallas`` ``:196``).
* :func:`edge_dot_cuda` (K6) — ``out[e, h] = <a[src_e], b[dst_e]>`` per
  head; the coefficient cotangent of K1 (``_edge_dot`` ``:390``).
* :func:`gather_scale_segment_sum_q_cuda` (K4) — K1 on uint8 rows
  dequantized in registers (``gather_scale_segment_sum_q_pallas``
  ``:531``), forward only.

The TPU kernels tile the reductions as one-hot matmuls because a TPU has
no efficient scatter.  These walk a grouped layout instead: ``order``
lists the edges stably sorted by the grouping index and
``row_ptr[d]:row_ptr[d+1]`` is group ``d``'s range (:func:`dst_layout`).
Each output row is owned by the lanes that write it once (K1 and K4: a
group of lanes under a :func:`lane_plan`, shared with GAT's kernels;
K2: one CUDA block), so there are no atomics and every sum is bitwise
repeatable.  See ``csrc/segment_sum.cu`` for the bounds.

An edge a layout does not list (a masked pad slot) is never read: the
per-edge outputs of K5 and K6 are zero there.

The plain versions take the same arguments, layout included, so the CPU
tests exercise exactly what the kernels read; they stay differentiable
through autograd.  :func:`pick` chooses one or the other by the tensor's
device.  The ``torch.autograd.Function``\\ s at the end make K1, K2 and
the row gather differentiable on both devices: their forward and
backward call :mod:`repro_torch.kernels.ops`, so the CPU tests run the
same backward formulas as the card.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

#: launches per kernel wrapper (plain integers; a run resets and reads
#: them to show that a path went through the kernels).  K1 counts its
#: launches over a dst-grouped layout and over the src-grouped layout
#: (the transpose, from a backward) apart.
launches = {"gather_scale_segment_sum": 0, "gather_scale_segment_sum_t": 0,
            "segment_sum": 0, "gather_scale_segment_sum_q": 0,
            "gather_rows": 0, "edge_dot": 0}
#: K1's launches again, by counter and row width: ``{(counter, F): n}``
#: (reset with ``launches``)
launches_by_width: dict = {}

Layout = Tuple[torch.Tensor, torch.Tensor]

WARP = 32
#: K1's and K4's range of vectors a lane (a 602-wide row of float2 is one
#: warp of 10 a lane) and the elements of gathered rows a lane may hold
#: in flight: over a whole graph and for K4, and for K1 over a block
#: (``csrc/segment_sum.cu``: GSS_MAX_VPL, GSS_WHOLE_WORDS, GSS_MAX_WORDS)
GSS_MAX_VPL = 12
GSS_WHOLE_WORDS = 24
GSS_MAX_WORDS = 80
# Over at least this many destinations (a whole graph, not a served
# block) a lane takes 16 floats of a row instead of 8: two destinations a
# warp at 4 x 64.  On GAT's graph (232 965 destinations) K3 took 0.415
# against 0.452 ms and the VJP's destination pass 0.480 against 0.497; on
# a served block (1 664 destinations, fanout 10) K3 took 0.0163 against
# 0.0122 (scripts/gat_lane_plans.py on an NVIDIA H100 80GB HBM3, 700 W)
WIDE_DST = 1 << 16


def dst_layout(edge_dst: np.ndarray, num_dst: int,
               mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side dst-grouped layout of an edge list: ``(order, row_ptr)``
    as int32, ``order`` a stable argsort of ``edge_dst`` over the edges
    with ``mask`` set (all edges when ``mask`` is None) and ``row_ptr``
    the (num_dst + 1,) prefix sum of their per-destination counts.
    Called with ``edge_src`` and ``num_src`` it gives the src-grouped
    layout the transposes walk.

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


def pick(cuda_fn: Callable, plain_fn: Callable, t: torch.Tensor) -> Callable:
    """The kernel wrapper for a CUDA tensor, the plain version for a CPU
    tensor; any other device raises.  Nothing falls back."""
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no kernel for device {t.device}")


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


def _check_view(t: torch.Tensor, name: str, dtype: torch.dtype,
                device: torch.device, shape) -> None:
    """Like :func:`_check` for a kernel that reads through strides: the
    exact shape, and only the last dim contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dim() and t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dim must be contiguous")


#: TMA's alignment: the base address and every stride it steps, in bytes
TMA_ALIGN = 16


def _check_tma(t: torch.Tensor, name: str, dim_names) -> None:
    """A view that a TMA map can read or write: a 16-byte-aligned base and
    byte strides in multiples of 16 along the leading dims ``dim_names``
    names, where they are longer than 1 (a dim of length 1 is never
    stepped).  Raises ``ValueError`` naming the tensor."""
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"{name}'s base address is not {TMA_ALIGN}-byte "
                         f"aligned, as TMA needs")
    for dim, what in enumerate(dim_names):
        nbytes = t.stride(dim) * t.element_size()
        if t.shape[dim] > 1 and nbytes % TMA_ALIGN:
            raise ValueError(f"{name}'s {what} stride of {nbytes} bytes is "
                             f"not a multiple of {TMA_ALIGN}, as TMA needs")


def _check_layout(order: torch.Tensor, row_ptr: torch.Tensor, num_dst: int,
                  device: torch.device) -> None:
    _check(order, "order", torch.int32, 1, device)
    _check(row_ptr, "row_ptr", torch.int32, 1, device)
    if row_ptr.shape[0] != num_dst + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries, "
                         f"expected num_dst + 1 = {num_dst + 1}")


def _require_cuda(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {t.device}")
    return t.device


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _segments(row_ptr: torch.Tensor, n: int) -> torch.Tensor:
    """Group id of each listed position (the plain versions' index)."""
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=row_ptr.device),
                                   counts)


# ---------------------------------------------------------------------------
# lane plans: how the lane-group kernels (K1, K4, K3) lay a row over lanes
# ---------------------------------------------------------------------------

def lane_plan(heads: int, hd: int, align: int = 16,
              floats_per_lane: int = 8, *, max_vpl: int) -> dict:
    """How the lane-group kernels (``csrc/lanes.cuh``: K3 and its VJP's
    destination pass in ``csrc/gat_fused.cu``, K1 and K4 in
    ``csrc/segment_sum.cu``) lay a destination's row of ``heads * hd``
    columns over groups of lanes: ``vec`` floats a load (the widest of 4,
    2, 1 dividing ``hd`` and ``align``, the pointers' common byte
    alignment), ``hpg`` heads a group (a destination takes ``ceil(heads /
    hpg)`` groups), ``lph`` lanes a head and ``vpl`` vectors a lane
    (``lph * vpl`` vectors cover the head), ``group`` lanes a group (the
    power of two holding ``hpg * lph``).  Of the plans with at most
    ``max_vpl`` vectors a lane, the one with the fewest idle vector slots,
    then the one nearest ``floats_per_lane`` floats a lane, then the one
    with the most heads a group (fewer index loads).  Raises
    ``ValueError`` when no plan fits a warp."""
    if not 0 < heads <= WARP or hd < 0:
        raise ValueError(f"{heads} heads of width {hd}: the lane-group "
                         f"kernels take 1..{WARP} heads")
    vec = next(v for v in (4, 2, 1) if hd % v == 0 and align % (4 * v) == 0)
    nvh = hd // vec
    best = None
    for hpg in range(1, heads + 1):
        lph = 1
        while hpg * lph <= WARP:
            vpl = max(1, -(-nvh // lph))
            if vpl <= max_vpl:
                group = 1 << (hpg * lph - 1).bit_length()
                slots = -(-heads // hpg) * group * vpl
                key = ((slots - heads * nvh) / slots,
                       abs(vpl * vec - floats_per_lane), -hpg)
                if best is None or key < best[0]:
                    best = (key, {"vec": vec, "hpg": hpg, "lph": lph,
                                  "vpl": vpl, "group": group})
            lph *= 2
    if best is None:
        raise ValueError(f"{heads} heads of width {hd} do not fit one warp "
                         f"of at most {max_vpl} vectors of {vec} a lane")
    return best[1]


def _floats_per_lane(num_dst: int) -> int:
    return 16 if num_dst >= WIDE_DST else 8


def _align(*tensors) -> int:
    """The common byte alignment (16, 8 or 4) of the tensors' bases."""
    bits = 0
    for t in tensors:
        bits |= t.data_ptr()
    return 16 if bits % 16 == 0 else 8 if bits % 8 == 0 else 4


#: edges whose rows a lane of K1 or K4 may have in flight
GSS_NES = (1, 2, 4)
#: over a block (fewer than WIDE_DST destinations) a lane of K1 or K4
#: holds at most this many floats of a row: a wider row is cut into slices
BLOCK_FLOATS = 16


def gss_ne(words: int, budget: int) -> int:
    """The most of :data:`GSS_NES` edges whose rows of ``words`` elements
    a lane fit ``budget`` elements (one when none fits)."""
    return max([n for n in GSS_NES if n * words <= budget], default=1)


def gss_built(vec: int, vpl: int, ne: int, quantized: bool = False) -> bool:
    """Whether ``csrc/segment_sum.cu`` builds K1's (K4's with
    ``quantized``) instance of ``vpl`` vectors of ``vec`` a lane and
    ``ne`` edges in flight: the ones :func:`gss_plan` can pick
    (``gss_instance`` there)."""
    words = vpl * vec
    return 1 <= vpl <= GSS_MAX_VPL and (
        ne == gss_ne(words, GSS_WHOLE_WORDS)
        or not quantized and ne == gss_ne(words, GSS_MAX_WORDS))


def gss_plan(heads: int, hd: int, align: int = 16, num_dst: int = 0, *,
             quantized: bool = False) -> dict:
    """K1's lane plan (K4's with ``quantized``: rows of bytes, one head):
    :func:`lane_plan` with up to :data:`GSS_MAX_VPL` vectors a lane, plus
    ``nsl``, the slices a head is cut into (each a group of its own), and
    ``ne``, the edges whose rows a lane has in flight.

    Over a whole graph (at least :data:`WIDE_DST` destinations) K1 is
    bound by the gathered rows in flight on each SM: a lane takes 16
    floats, a head is sliced only when one warp cannot hold it, and ``ne``
    is the most of :data:`GSS_NES` within :data:`GSS_WHOLE_WORDS` floats a
    lane (one at 602 and 256 wide, two at 41 and 4 x 10), so registers
    stay few and resident warps many.  Over a block (a served block, a
    mini-batch block) the time is its slowest destination's latency: a
    lane takes 8 floats, a row wider than a warp of
    :data:`BLOCK_FLOATS` floats a lane is sliced (602 wide: two warps of
    5 float2 a lane), and ``ne`` is the most within
    :data:`GSS_MAX_WORDS`, but K4 keeps :data:`GSS_WHOLE_WORDS` (its
    bytes and scales take registers of their own).  All from
    ``scripts/k1_lane_plans.py`` on an NVIDIA H100 80GB HBM3, 700 W
    (PERF.md, PR 17).  The search runs once per shape: each launch asks
    again."""
    return dict(_gss_plan(heads, hd, align, num_dst >= WIDE_DST, quantized))


@functools.lru_cache(maxsize=None)
def _gss_plan(heads: int, hd: int, align: int, whole: bool,
              quantized: bool) -> tuple:
    vec = next(v for v in (4, 2, 1) if hd % v == 0 and align % (4 * v) == 0)
    nvh = hd // vec
    per_lane = GSS_MAX_VPL if whole else min(GSS_MAX_VPL,
                                             BLOCK_FLOATS // vec)
    nsl = max(1, -(-nvh // (WARP * per_lane)))
    # a sliced head, or more heads than a warp has lanes: each (slice of
    # a) head is a group of its own
    one = nsl > 1 or heads > WARP
    plan = lane_plan(1 if one else heads, -(-nvh // nsl) * vec, 4 * vec,
                     _floats_per_lane(WIDE_DST if whole else 0),
                     max_vpl=GSS_MAX_VPL)
    budget = GSS_WHOLE_WORDS if whole or quantized else GSS_MAX_WORDS
    plan.update(nsl=nsl, ne=gss_ne(plan["vpl"] * vec, budget))
    return tuple(plan.items())


# ---------------------------------------------------------------------------
# K1: fused gather -> scale -> segment-sum (and its transpose)
# ---------------------------------------------------------------------------

def gather_scale_segment_sum_plain(h: torch.Tensor, edge_src: torch.Tensor,
                                   coef: torch.Tensor, order: torch.Tensor,
                                   row_ptr: torch.Tensor, num_dst: int, *,
                                   col: Optional[torch.Tensor] = None):
    """Plain PyTorch K1 over a grouped layout: ``index_add_`` of the
    scaled rows ``h[edge_src[e]]`` of the listed edges.  ``coef`` is
    (E,), or (E, heads) to scale each head's ``F / heads`` columns by its
    own coefficient.  Given ``col`` (E, heads), returns ``(out,
    col_out)``, ``col_out`` the (num_dst, heads) sum of ``col`` over each
    group's listed edges."""
    e = order.long()
    seg = _segments(row_ptr, num_dst)
    rows = h[edge_src.long()[e]]
    c = coef[e]
    if c.dim() == 1:
        msgs = rows * c[:, None]
    else:
        heads = c.shape[1]
        msgs = (rows.reshape(len(e), heads, h.shape[1] // heads)
                * c[..., None]).reshape(len(e), h.shape[1])
    out = torch.zeros((num_dst, h.shape[1]), dtype=h.dtype, device=h.device)
    out = out.index_add(0, seg, msgs)
    if col is None:
        return out
    return out, torch.zeros((num_dst, col.shape[1]), dtype=col.dtype,
                            device=col.device).index_add(0, seg, col[e])


def _plan_args(plan: dict, quantized: bool = False) -> tuple:
    """A K1 / K4 plan as the C entry points take it: (vec, hpg, lph, vpl,
    nsl, group, ne), K4 without hpg (one head)."""
    keys = ("vec", "lph", "vpl", "nsl", "group", "ne") if quantized \
        else ("vec", "hpg", "lph", "vpl", "nsl", "group", "ne")
    return tuple(plan[k] for k in keys)


def gather_scale_segment_sum_cuda(h: torch.Tensor, edge_src: torch.Tensor,
                                  coef: torch.Tensor, order: torch.Tensor,
                                  row_ptr: torch.Tensor, num_dst: int, *,
                                  transpose: bool = False,
                                  col: Optional[torch.Tensor] = None):
    """K1 on the card (``csrc/segment_sum.cu``, ``gss_forward``).
    ``transpose=True`` marks a launch over the src-grouped layout from a
    backward; it is counted under ``gather_scale_segment_sum_t``.  A
    ``col`` of ``coef``'s shape (E, heads) is summed in the same launch,
    as the plain version does."""
    dev = _require_cuda(h, "gather_scale_segment_sum_cuda")
    _check(h, "h", torch.float32, 2, dev)
    _check(edge_src, "edge_src", torch.int32, 1, dev)
    if coef.dim() not in (1, 2):
        raise ValueError(f"coef must be (E,) or (E, heads), got "
                         f"{tuple(coef.shape)}")
    _check(coef, "coef", torch.float32, coef.dim(), dev)
    if coef.shape[0] != edge_src.shape[0]:
        raise ValueError("coef and edge_src differ in length")
    heads = 1 if coef.dim() == 1 else coef.shape[1]
    F = h.shape[1]
    if heads < 1 or F % heads:
        raise ValueError(f"{F} columns do not split into {heads} heads")
    _check_layout(order, row_ptr, num_dst, dev)
    out = torch.empty((num_dst, F), dtype=torch.float32, device=dev)
    col_out = None
    if col is not None:
        _check(col, "col", torch.float32, 2, dev)
        if tuple(col.shape) != (edge_src.shape[0], heads):
            raise ValueError(f"col {tuple(col.shape)} must be (E, heads) = "
                             f"{(edge_src.shape[0], heads)}")
        col_out = (torch.zeros if F == 0 else torch.empty)(
            (num_dst, heads), dtype=torch.float32, device=dev)
    if num_dst == 0 or F == 0:
        return out if col is None else (out, col_out)
    plan = gss_plan(heads, F // heads, _align(h, out), num_dst)
    lib = build.library("segment_sum")
    build.check(lib.gss_forward(
        h.data_ptr(), edge_src.data_ptr(), coef.data_ptr(),
        None if col is None else col.data_ptr(), order.data_ptr(),
        row_ptr.data_ptr(), out.data_ptr(),
        None if col is None else col_out.data_ptr(), num_dst, F, heads,
        *_plan_args(plan), _stream()), "gss_forward")
    name = ("gather_scale_segment_sum_t" if transpose
            else "gather_scale_segment_sum")
    launches[name] += 1
    launches_by_width[name, F] = launches_by_width.get((name, F), 0) + 1
    return out if col is None else (out, col_out)


# ---------------------------------------------------------------------------
# K2: segment-sum of per-edge messages
# ---------------------------------------------------------------------------

def segment_sum_plain(msgs: torch.Tensor, order: torch.Tensor,
                      row_ptr: torch.Tensor, num_dst: int) -> torch.Tensor:
    """Plain PyTorch K2 over a grouped layout: ``index_add_`` of the
    listed message rows."""
    seg = _segments(row_ptr, num_dst)
    out = torch.zeros((num_dst, msgs.shape[1]), dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add(0, seg, msgs[order.long()])


def segment_sum_cuda(msgs: torch.Tensor, order: torch.Tensor,
                     row_ptr: torch.Tensor, num_dst: int) -> torch.Tensor:
    """K2 on the card (``csrc/segment_sum.cu``, ``seg_forward``)."""
    dev = _require_cuda(msgs, "segment_sum_cuda")
    _check(msgs, "msgs", torch.float32, 2, dev)
    _check_layout(order, row_ptr, num_dst, dev)
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


# ---------------------------------------------------------------------------
# K5: row gather (the transpose of K2)
# ---------------------------------------------------------------------------

def _edge_output(nnz: int, shape, device) -> torch.Tensor:
    """A per-edge output: zeros where edges go unlisted, else uninit."""
    fill = torch.empty if nnz == shape[0] else torch.zeros
    return fill(shape, dtype=torch.float32, device=device)


def gather_rows_plain(g: torch.Tensor, seg: torch.Tensor,
                      order: torch.Tensor, num_edges: int) -> torch.Tensor:
    """Plain PyTorch K5: ``out[e] = g[seg[e]]`` for the edges ``order``
    lists, zero rows for the others."""
    e = order.long()
    out = torch.zeros((num_edges, g.shape[1]), dtype=g.dtype,
                      device=g.device)
    return out.index_copy(0, e, g[seg.long()[e]])


def gather_rows_cuda(g: torch.Tensor, seg: torch.Tensor,
                     order: torch.Tensor, num_edges: int) -> torch.Tensor:
    """K5 on the card (``csrc/segment_sum.cu``, ``gather_rows``)."""
    dev = _require_cuda(g, "gather_rows_cuda")
    _check(g, "g", torch.float32, 2, dev)
    _check(seg, "seg", torch.int32, 1, dev)
    _check(order, "order", torch.int32, 1, dev)
    if seg.shape[0] != num_edges or order.shape[0] > num_edges:
        raise ValueError(f"seg has {seg.shape[0]} and order "
                         f"{order.shape[0]} entries for {num_edges} edges")
    nnz, F = order.shape[0], g.shape[1]
    out = _edge_output(nnz, (num_edges, F), dev)
    if nnz == 0 or F == 0:
        return out
    lib = build.library("segment_sum")
    build.check(lib.gather_rows(
        g.data_ptr(), seg.data_ptr(), order.data_ptr(), out.data_ptr(),
        nnz, F, _stream()), "gather_rows")
    launches["gather_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# K6: per-edge, per-head dot product (the coefficient cotangent of K1)
# ---------------------------------------------------------------------------

def edge_dot_plain(a: torch.Tensor, b: torch.Tensor, edge_src: torch.Tensor,
                   edge_dst: torch.Tensor, order: torch.Tensor,
                   heads: int = 1) -> torch.Tensor:
    """Plain PyTorch K6: ``out[e, h] = <a[src_e, h-th slice],
    b[dst_e, h-th slice]>`` (slices of ``F / heads`` columns) for the
    listed edges, zero for the others.  Returns (E, heads)."""
    e = order.long()
    hd = a.shape[1] // heads
    ra = a[edge_src.long()[e]].reshape(len(e), heads, hd)
    rb = b[edge_dst.long()[e]].reshape(len(e), heads, hd)
    out = torch.zeros((edge_src.shape[0], heads), dtype=a.dtype,
                      device=a.device)
    return out.index_copy(0, e, (ra * rb).sum(-1))


def edge_dot_cuda(a: torch.Tensor, b: torch.Tensor, edge_src: torch.Tensor,
                  edge_dst: torch.Tensor, order: torch.Tensor,
                  heads: int = 1) -> torch.Tensor:
    """K6 on the card (``csrc/segment_sum.cu``, ``edge_dot``)."""
    dev = _require_cuda(a, "edge_dot_cuda")
    _check(a, "a", torch.float32, 2, dev)
    _check(b, "b", torch.float32, 2, dev)
    _check(edge_src, "edge_src", torch.int32, 1, dev)
    _check(edge_dst, "edge_dst", torch.int32, 1, dev)
    _check(order, "order", torch.int32, 1, dev)
    F, E = a.shape[1], edge_src.shape[0]
    if b.shape[1] != F or heads < 1 or F % heads:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"share a width that splits into {heads} heads")
    if edge_dst.shape[0] != E or order.shape[0] > E:
        raise ValueError("edge_src, edge_dst and order do not match")
    nnz = order.shape[0]
    out = _edge_output(nnz, (E, heads), dev)
    if nnz == 0:
        return out
    if F == 0:
        return out.zero_()
    lib = build.library("segment_sum")
    build.check(lib.edge_dot(
        a.data_ptr(), b.data_ptr(), edge_src.data_ptr(), edge_dst.data_ptr(),
        order.data_ptr(), out.data_ptr(), nnz, F, heads, _stream()),
        "edge_dot")
    launches["edge_dot"] += 1
    return out


# ---------------------------------------------------------------------------
# K4: K1 on int8 wire rows, dequantized in registers
# ---------------------------------------------------------------------------

def gather_scale_segment_sum_q_plain(q: torch.Tensor, mn: torch.Tensor,
                                     scale: torch.Tensor,
                                     edge_src: torch.Tensor,
                                     coef: torch.Tensor, order: torch.Tensor,
                                     row_ptr: torch.Tensor,
                                     num_dst: int) -> torch.Tensor:
    """Plain PyTorch K4: decode ``mn + q * scale`` (the codec's own
    arithmetic), then plain K1."""
    h = mn + q.to(torch.float32) * scale
    return gather_scale_segment_sum_plain(h, edge_src, coef, order, row_ptr,
                                          num_dst)


def gather_scale_segment_sum_q_cuda(q: torch.Tensor, mn: torch.Tensor,
                                    scale: torch.Tensor,
                                    edge_src: torch.Tensor,
                                    coef: torch.Tensor, order: torch.Tensor,
                                    row_ptr: torch.Tensor,
                                    num_dst: int) -> torch.Tensor:
    """K4 on the card (``csrc/segment_sum.cu``, ``gssq_forward``)."""
    dev = _require_cuda(q, "gather_scale_segment_sum_q_cuda")
    _check(q, "q", torch.uint8, 2, dev)
    S, F = q.shape
    for t, name in ((mn, "mn"), (scale, "scale")):
        _check(t, name, torch.float32, 2, dev)
        if tuple(t.shape) != (S, 1):
            raise ValueError(f"{name} must be ({S}, 1), got "
                             f"{tuple(t.shape)}")
    _check(edge_src, "edge_src", torch.int32, 1, dev)
    _check(coef, "coef", torch.float32, 1, dev)
    if coef.shape[0] != edge_src.shape[0]:
        raise ValueError("coef and edge_src differ in length")
    _check_layout(order, row_ptr, num_dst, dev)
    out = torch.empty((num_dst, F), dtype=torch.float32, device=dev)
    if num_dst == 0 or F == 0:
        return out
    # the uint8 rows set the vector width (602-byte rows are 2-byte
    # aligned, uchar2); the float output row takes the same width
    vec = next(v for v in (4, 2, 1)
               if F % v == 0 and q.data_ptr() % v == 0
               and out.data_ptr() % (4 * v) == 0)
    plan = gss_plan(1, F, 4 * vec, num_dst, quantized=True)
    lib = build.library("segment_sum")
    build.check(lib.gssq_forward(
        q.data_ptr(), mn.data_ptr(), scale.data_ptr(), edge_src.data_ptr(),
        coef.data_ptr(), order.data_ptr(), row_ptr.data_ptr(),
        out.data_ptr(), num_dst, F, *_plan_args(plan, quantized=True),
        _stream()), "gssq_forward")
    launches["gather_scale_segment_sum_q"] += 1
    return out


# ---------------------------------------------------------------------------
# autograd Functions (both devices: forward and backward go through ops)
# ---------------------------------------------------------------------------

def _need_layout(layout: Optional[Layout], what: str) -> None:
    if layout is None:
        raise ValueError(
            f"{what} needs the src-grouped layout to differentiate: build "
            f"the DeviceGraph with src_layout=True")


class GatherScaleSegmentSum(torch.autograd.Function):
    """K1 with its VJP: ``dh`` is K1 over the src-grouped layout with
    source and destination swapped (``dh[s] = sum_{e: src_e=s} coef_e *
    g[dst_e]``), ``dcoef`` is K6.  Each is computed only when asked for."""

    @staticmethod
    def forward(ctx, h, edge_src, edge_dst, coef, order, row_ptr,
                src_layout, num_dst):
        from repro_torch.kernels import ops
        if ctx.needs_input_grad[0]:
            _need_layout(src_layout, "gather_scale_segment_sum")
        ctx.src_layout = src_layout
        ctx.save_for_backward(h, edge_src, edge_dst, coef, order)
        return ops.gather_scale_segment_sum(h, edge_src, coef, order,
                                            row_ptr, num_dst)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import ops
        h, edge_src, edge_dst, coef, order = ctx.saved_tensors
        g = g.contiguous()
        dh = dcoef = None
        if ctx.needs_input_grad[0]:
            order_s, row_ptr_s = ctx.src_layout
            dh = ops.gather_scale_segment_sum(g, edge_dst, coef, order_s,
                                              row_ptr_s, h.shape[0],
                                              transpose=True)
        if ctx.needs_input_grad[3]:
            dcoef = ops.edge_dot(h, g, edge_src, edge_dst, order)[:, 0]
        return dh, None, None, dcoef, None, None, None, None


class SegmentSum(torch.autograd.Function):
    """K2 with its VJP, K5: ``dmsgs[e] = g[seg_e]`` on the listed edges
    (zero on the others, which the forward never read)."""

    @staticmethod
    def forward(ctx, msgs, seg, order, row_ptr, num_dst):
        from repro_torch.kernels import ops
        ctx.save_for_backward(seg, order)
        return ops.segment_sum(msgs, order, row_ptr, num_dst)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import ops
        seg, order = ctx.saved_tensors
        return (ops.gather_rows(g.contiguous(), seg, order, seg.shape[0]),
                None, None, None, None)


class GatherRows(torch.autograd.Function):
    """The Scatter step as K5, ``out[e] = x[idx_e]`` on the listed edges,
    with its VJP: K2 over the layout grouped by ``idx``.  Unlike
    indexing's own backward, the sum has no float atomics.  Given that
    layout, K5 walks the listed edges in its order (the same edges as
    ``order``, grouped by ``idx``), so each row of ``x`` is read once, in
    turn."""

    @staticmethod
    def forward(ctx, x, idx, order, idx_layout):
        from repro_torch.kernels import ops
        if ctx.needs_input_grad[0]:
            _need_layout(idx_layout, "the Scatter gather")
        ctx.idx_layout = idx_layout
        ctx.num_rows = x.shape[0]
        walk = order if idx_layout is None else idx_layout[0]
        return ops.gather_rows(x, idx, walk, idx.shape[0])

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import ops
        order_i, row_ptr_i = ctx.idx_layout
        return (ops.segment_sum(g.contiguous(), order_i, row_ptr_i,
                                ctx.num_rows), None, None, None)
