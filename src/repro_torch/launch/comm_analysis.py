"""Cost counters of the sharding-plan dry run: the counterpart of the
reference's ``launch/hlo_analysis.py``, which sums the collectives of a
compiled post-SPMD HLO module.  Here the step runs eagerly on DTensors
over a fake process group, and :class:`CostCounter` (a
``TorchDispatchMode``) sees every op on the local shards, after DTensor
has lowered it:

* collectives: the output bytes of every ``_c10d_functional`` op, by
  kind (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``, plus ``total``), as ``collective_bytes`` sums HLO
  output shapes, each with the mesh axis it ran over;
* FLOPs of the matrix products on the local shards
  (``torch.utils.flop_counter``'s formulas; elementwise work is not
  counted);
* HBM bytes: every non-view local op's inputs read once and outputs
  written once (an unfused count: what eager kernels would move);
* the peak of live local bytes: every storage an op outputs (and the
  step's arguments, :meth:`CostCounter.track`) from its allocation until
  it is freed.  ``torch.distributed._tools.mem_tracker.MemTracker`` would
  count the same, but its filter of DTensor's propagation ops differs
  between torch releases (the card's 2.11 counts their global shapes),
  so the counter keeps its own.

Roofline constants are the card's datasheet figures, H100 SXM5 80GB at
700 W, not measurements.
"""
from __future__ import annotations

import contextlib
import contextvars
import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12          # H100 SXM5 bf16 dense FLOP/s (datasheet)
HBM_BW = 3.35e12             # H100 SXM5 HBM3 bytes/s (datasheet)
NVLINK_BW = 450e9            # NVLink 4, bytes/s each way a card
NVLINK_MAX_CARDS = 8         # an axis of at most 8 cards stays on a node
# ASSUMPTION, not a datasheet figure: one 400 Gb/s NIC a card
NET_BW = 50e9                # bytes/s a card across nodes

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

#: set while DTensor's all-to-all runs as its CPU fallback (an all-gather
#: and a chunk): the gather is booked as the all-to-all it stands for
_IN_ALLTOALL: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_in_alltoall", default=None)


def axis_bandwidth(axis_size: int) -> float:
    """Bytes/s a card for a collective over an axis of ``axis_size``
    cards: NVLink within a node of 8, else the assumed network figure."""
    return NVLINK_BW if axis_size <= NVLINK_MAX_CARDS else NET_BW


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class CostCounter(TorchDispatchMode):
    """Counts what the local shards do (see the module docstring).  Ops
    on DTensors return ``NotImplemented`` here, so DTensor lowers them
    first and the counter sees the local ops and collectives it issues.

    ``group_axes`` maps a process group's name to its mesh axis
    (:func:`group_axes`)."""

    def __init__(self, group_axes: Optional[Dict[str, str]] = None):
        super().__init__()
        self.group_axes = group_axes or {}
        self.coll: Dict[str, int] = defaultdict(int)
        self.coll_by_axis: Dict[tuple, int] = defaultdict(int)
        self.log: list = []
        self.flops = 0
        self.hbm_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        from torch.utils.weak import WeakIdKeyDictionary
        self._live = WeakIdKeyDictionary()

    def __enter__(self):
        from torch._guards import active_fake_mode
        # DTensor's sharding propagation runs ops on global shapes under a
        # nested FakeTensorMode of its own: they are not counted
        self._entry_fake = active_fake_mode()
        return super().__enter__()

    def track(self, *tensors) -> None:
        """Counts each tensor's storage as live until it is freed (once a
        storage, whatever views of it there are)."""
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._live:
                continue
            n = st.nbytes()
            self._live[st] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def book(self, kind: str, nbytes: int, axis: str) -> None:
        self.coll[kind] += nbytes
        self.coll["total"] += nbytes
        self.coll_by_axis[(kind, axis)] += nbytes
        self.log.append((kind, axis, nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        from torch._guards import active_fake_mode
        if active_fake_mode() is not self._entry_fake:
            return out
        self.track(*tree_flatten(out)[0])
        name = func.overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = _KINDS.get(name)
            if kind is not None:
                group = next((a for a in reversed(args) if isinstance(a, str)
                              and a in self.group_axes), None)
                axis = self.group_axes.get(group, "?")
                pending = _IN_ALLTOALL.get()
                if pending is not None and kind == "all-gather":
                    kind, nbytes = "all-to-all", pending
                else:
                    nbytes = sum(_nbytes(t) for t in tree_flatten(out)[0])
                self.book(kind, nbytes, axis)
            return out
        from torch.utils.flop_counter import flop_registry
        if func.overloadpacket in flop_registry:
            self.flops += int(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        if not func.is_view:
            self.hbm_bytes += sum(_nbytes(t) for t in tree_flatten(
                (args, kwargs))[0]) + sum(_nbytes(t)
                                          for t in tree_flatten(out)[0])
        return out

    def summary(self) -> dict:
        out = {"flops": float(self.flops),
               "hbm_bytes": float(self.hbm_bytes)}
        for k, v in self.coll.items():
            out[f"coll/{k}"] = float(v)
        return out


def group_axes(mesh) -> Dict[str, str]:
    """``{process group name: mesh axis}`` of every axis of ``mesh``."""
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


@contextlib.contextmanager
def alltoall_as_alltoall():
    """Books DTensor's CPU all-to-all fallback (``shard_dim_alltoall`` on
    a CPU mesh: an all-gather, then a chunk) as one all-to-all of its
    input's bytes, the bytes a real all-to-all outputs."""
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import placement_types as pt
    orig = cu.shard_dim_alltoall

    def counted(input, *a, **kw):
        tok = _IN_ALLTOALL.set(_nbytes(input))
        try:
            return orig(input, *a, **kw)
        finally:
            _IN_ALLTOALL.reset(tok)

    mods = [m for m in (cu, pt) if getattr(m, "shard_dim_alltoall", None)
            is orig]
    for m in mods:
        m.shard_dim_alltoall = counted
    try:
        yield
    finally:
        for m in mods:
            m.shard_dim_alltoall = orig


@contextlib.contextmanager
def propagation_apart():
    """DTensor's sharding propagation runs each op once on global shapes
    to learn its output's metadata, under the fake mode it detects (the
    dry run's own).  This gives it a fresh ``FakeTensorMode`` instead, so
    that :class:`CostCounter` (which skips ops under a fake mode other
    than the one it was entered under) sees only the local ops."""
    from torch.distributed.tensor import _sharding_prop as sp
    orig = sp.detect_fake_mode
    sp.detect_fake_mode = lambda *a, **k: None
    try:
        yield
    finally:
        sp.detect_fake_mode = orig


def collective_seconds(coll_by_axis: Dict[tuple, int], sizes: dict) -> float:
    """Seconds of the collectives at the axis bandwidths
    (:func:`axis_bandwidth`): each axis's bytes over its rate, summed."""
    total = 0.0
    for (kind, axis), nbytes in coll_by_axis.items():
        total += nbytes / axis_bandwidth(sizes.get(axis, 1 << 30))
    return total
