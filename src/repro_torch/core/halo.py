"""Ownership + halo (ghost) vertex layout for partition-aware training.

The surveyed distributed mini-batch systems (DistDGL, PaGraph, DistGNN —
§3.2.1/§3.2.4) split a graph with an edge-cut partitioner and then give
each partition two vertex sets:

* **owned** — vertices the partition is responsible for (its seeds, its
  labels, its slice of the feature matrix);
* **halo** (ghost) — remote endpoints of cut edges: the vertices whose
  features/embeddings must be fetched from other partitions to aggregate
  onto owned destinations.

This module computes both from any :class:`EdgeCutPartition`, plus
fixed-shape exchange index arrays (every partition's halo list padded to
one common cap) so a halo feature exchange is a single static-shape
gather per partition.

:class:`HaloExchange` layers *versioned per-layer ghost buffers* on top of
a :class:`HaloLayout`: the historical-embedding idea (GNNAutoScale /
PipeGCN / DistGNN's delayed aggregates, survey §3.2.7) applied to
full-graph training.  Each layer's ghost activations live in a
:class:`GhostPlane` (a :class:`~repro_torch.core.caching.VersionedBuffer`
whose values stay on the training device and whose versions stay on the
host) under the shared :class:`~repro_torch.core.caching.VersionClock`;
a refresh *plan* per step picks
which ghost rows are exchanged synchronously (every row whose staleness
would exceed the bound, plus a budgeted fraction of the oldest rest) and
charges exactly those rows as cross-partition traffic — priced at the
wire size of the exchange's :class:`~repro_torch.core.comm.WireCodec`,
the unified communication plane every transfer path shares.

A port of the reference's module: layouts, plans, versions and bytes are
the reference's, integer for integer.  Every rank of the distributed
trainer holds the same replicated exchange and makes the same plans.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

import torch

from repro_torch.core import telemetry
from repro_torch.core.caching import NEVER, VersionClock, VersionedBuffer
from repro_torch.core.comm import HEADER_BYTES, WireCodec, resolve_codec
from repro_torch.core.partitioning import EdgeCutPartition
from repro_torch.graph.structure import Graph


@dataclasses.dataclass
class HaloLayout:
    """Per-partition ownership + ghost layout of an edge-cut partition.

    ``owner`` maps every vertex to its partition; per partition ``p``,
    ``owned[p]`` are its vertices and ``halo[p] = halo_in[p] ∪
    halo_out[p]`` its ghosts (remote endpoints of cut edges, split by
    fetch direction).  ``halo_idx``/``halo_mask`` are the fixed-shape
    exchange indices: every partition's ghost list padded to one common
    ``halo_cap`` (``-1`` pads, mask marks validity) so a halo exchange is
    one static-shape gather per partition — pad slots stay zero and never
    alias a real vertex.
    """
    n_parts: int
    owner: np.ndarray            # (N,) vertex -> owning partition
    owned: List[np.ndarray]      # per-partition owned vertex ids (sorted)
    halo_in: List[np.ndarray]    # remote in-neighbors of owned vertices
    halo_out: List[np.ndarray]   # remote out-neighbors of owned vertices
    halo: List[np.ndarray]       # ghost set = halo_in ∪ halo_out (sorted)
    halo_idx: np.ndarray         # (P, H_cap) global ids, -1 pad
    halo_mask: np.ndarray        # (P, H_cap) slot validity

    @property
    def halo_cap(self) -> int:
        return self.halo_idx.shape[1]

    def ghost_fraction(self) -> float:
        """Mean #ghost copies per partition / N — the replication overhead
        an edge-cut pays (survey §3.2.1)."""
        n = len(self.owner)
        return float(np.mean([len(h) for h in self.halo]) / max(n, 1))

    # -- fixed-shape exchange ----------------------------------------------
    def gather_halo(self, feats: np.ndarray) -> np.ndarray:
        """Pull each partition's halo feature rows into a (P, H_cap, F)
        buffer (pad slots zero).  Shape depends only on the layout, never
        on which partition is gathering."""
        out = np.zeros((self.n_parts, self.halo_cap, feats.shape[1]),
                       feats.dtype)
        out[self.halo_mask] = feats[self.halo_idx[self.halo_mask]]
        return out

    def scatter_halo(self, gathered: np.ndarray,
                     num_features: int) -> np.ndarray:
        """Inverse routing: write exchanged rows back to a global (N, F)
        buffer.  Round-trips exactly: scatter(gather(x)) restores x on
        every halo vertex (partitions holding the same ghost write
        identical rows)."""
        buf = np.zeros((len(self.owner), num_features), gathered.dtype)
        buf[self.halo_idx[self.halo_mask]] = gathered[self.halo_mask]
        return buf

    def exchange_bytes(self, bytes_per_row: int) -> int:
        """Bytes one full (uncached) halo exchange moves across partitions."""
        return int(sum(len(h) for h in self.halo)) * bytes_per_row


def build_halo(g: Graph, part: EdgeCutPartition) -> HaloLayout:
    """Classify every edge endpoint as owned-or-ghost per partition.

    For partition ``p``: a cut edge ``(u, v)`` with ``owner(v) == p``
    contributes ``u`` to ``halo_in[p]`` (needed to aggregate onto owned
    destinations, the pull direction); ``owner(u) == p`` contributes ``v``
    to ``halo_out[p]`` (push direction).  The ghost set is the union, so
    every endpoint of every edge touching ``p`` is owned or halo — the
    invariant the property tests assert.
    """
    owner = np.asarray(part.assignment)
    e = g.edges()
    src_o = owner[e[:, 0]]
    dst_o = owner[e[:, 1]]
    cut = src_o != dst_o
    owned, halo_in, halo_out, halo = [], [], [], []
    for p in range(part.n_parts):
        owned.append(np.flatnonzero(owner == p).astype(np.int64))
        hi = np.unique(e[cut & (dst_o == p), 0])
        ho = np.unique(e[cut & (src_o == p), 1])
        halo_in.append(hi)
        halo_out.append(ho)
        halo.append(np.union1d(hi, ho))
    cap = max(1, max((len(h) for h in halo), default=1))
    halo_idx = np.full((part.n_parts, cap), -1, np.int64)
    halo_mask = np.zeros((part.n_parts, cap), bool)
    for p, h in enumerate(halo):
        halo_idx[p, :len(h)] = h
        halo_mask[p, :len(h)] = True
    return HaloLayout(part.n_parts, owner, owned, halo_in, halo_out, halo,
                      halo_idx, halo_mask)


# ---------------------------------------------------------------------------
# versioned ghost buffers: staleness-bounded asynchronous halo exchange
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RefreshPlan:
    """One training step's ghost-refresh decision.

    Attributes:
        step:  the clock value this plan serves (the step index).
        masks: per-layer ``(n_rows,)`` bool — rows exchanged *synchronously*
               this step (they carry current-step values and gradients);
               every other ghost row is served stale from its buffer.
        rows_moved:   Σ over layers of refreshed ghost *copies* (a row
               ghosted by k partitions is sent k times).
        payload_bytes: rows_moved × the active codec's per-row wire size
               (``WireCodec.wire_bytes_per_row``, so compression shows up
               directly in every plan's estimate).
        header_bytes:  one per-RPC header per (partition, layer) that pulls
               at least one refreshed row this step.
    """
    step: int
    masks: List[np.ndarray]
    rows_moved: int
    payload_bytes: int
    header_bytes: int

    @property
    def bytes(self) -> int:
        """Total cross-partition bytes this plan moves."""
        return self.payload_bytes + self.header_bytes


class GhostPlane(VersionedBuffer):
    """A :class:`~repro_torch.core.caching.VersionedBuffer` whose values
    are a float32 ``(rows, dim)`` tensor on ``device`` (a ghost plane is
    read by every step on the device, and uploading it would cost more
    than the step) and whose per-row versions stay a host array."""

    def __init__(self, clock: VersionClock, rows: int, dim: int,
                 device="cpu") -> None:
        self.clock = clock
        self.values = torch.zeros((rows, dim), dtype=torch.float32,
                                  device=device)
        self.version = np.full(rows, NEVER, np.int64)

    def set_rows(self, rows: np.ndarray, plane: torch.Tensor) -> None:
        """Take ``plane``'s values (a full ``(rows, dim)`` plane) at the
        boolean host mask ``rows``; versions are left as they are."""
        m = torch.from_numpy(np.asarray(rows, bool)).to(self.values.device)
        self.values = torch.where(m[:, None], plane.detach(), self.values)


class HaloExchange:
    """Versioned per-layer ghost activation buffers over a halo layout.

    The asynchronous full-graph step (``repro_torch.distributed.async_train``)
    computes each layer with *historical* activations for ghost vertices:
    layer ``l``'s buffer holds a stale copy of the global layer-``l``
    output, refreshed row-by-row under a staleness bound.  This class owns
    those buffers, the shared version clock, the per-step refresh policy,
    and the traffic accounting.

    Refresh policy at step ``t`` (:meth:`plan_refresh`):

    * **must-refresh** — every ghost row whose age ``t - version`` exceeds
      ``max_staleness`` (so a stale read NEVER exceeds the bound; with
      ``max_staleness=0`` every ghost refreshes every step, degrading to
      the synchronous halo exchange);
    * **budget** — plus the oldest ``refresh_frac`` fraction of the
      remaining ghost rows, spreading refreshes so staleness (and per-step
      traffic) stays smooth instead of expiring in bursts.

    Only the *pull-direction* ghosts (``halo_in``: remote sources of edges
    into owned destinations) are buffered and charged — those are the rows
    a pull aggregation actually reads.  Rows that are nobody's ghost are
    never refreshed and never read remotely.

    Args:
        layout: ownership/ghost sets from :func:`build_halo`.
        layer_dims: widths of the buffered layer outputs, *innermost
            first* — for an L-layer GCN these are the inputs of layers
            ``1..L-1``, i.e. ``[hidden] * (L-1)``.
        max_staleness: bound ``S``; a stale read is at most ``S`` steps old.
        refresh_frac: extra per-step refresh budget as a fraction of the
            ghost set (``0.0`` = only must-refresh rows).
        relabel: optional old→new vertex id map (e.g.
            ``ShardedGraph.perm``) when buffers live in a relabeled/padded
            id space; ``n_rows`` then gives the padded row count.
        n_rows: buffer row count (default: number of vertices in
            ``layout``).
        codec: wire codec name or :class:`~repro_torch.core.comm.WireCodec`
            for refresh payloads.  Plans charge each refreshed ghost copy
            at ``codec.wire_bytes_per_row(dim)`` (fp32 → the historical
            ``4 × dim``), and the buffers are expected to hold the
            codec-*decoded* values (the step applies ``codec.qdq`` before
            :meth:`write_planes` stores them).
        clock: share an existing :class:`VersionClock` (e.g. with a
            serving cache); default: a private clock starting at 0.
        device: where the planes' values live (the training device).
    """

    def __init__(self, layout: HaloLayout, layer_dims: Sequence[int], *,
                 max_staleness: int = 0, refresh_frac: float = 0.0,
                 relabel: Optional[np.ndarray] = None,
                 n_rows: Optional[int] = None,
                 codec: "str | WireCodec" = "fp32",
                 clock: Optional[VersionClock] = None, device="cpu"):
        if max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if not 0.0 <= refresh_frac <= 1.0:
            raise ValueError("refresh_frac must be in [0, 1]")
        self.layout = layout
        self.max_staleness = max_staleness
        self.refresh_frac = refresh_frac
        self.codec = resolve_codec(codec)
        self.layer_dims = list(layer_dims)
        # per-layer wire size of one refreshed ghost row (codec-aware —
        # what RefreshPlan estimates and the bytes/step benches report)
        self.row_wire_bytes = [self.codec.wire_bytes_per_row(d)
                               for d in self.layer_dims]
        n = n_rows if n_rows is not None else len(layout.owner)
        if relabel is None:
            relabel = np.arange(len(layout.owner), dtype=np.int64)
        # pull-direction ghost membership: member[p, r] ⇔ row r must be
        # replicated at partition p for its aggregations
        self.member = np.zeros((layout.n_parts, n), bool)
        for p in range(layout.n_parts):
            self.member[p, relabel[layout.halo_in[p]]] = True
        self.copies = self.member.sum(0).astype(np.int64)   # (n_rows,)
        self.ghost_rows = self.copies > 0
        self.n_ghost = int(self.ghost_rows.sum())
        self.clock = clock if clock is not None else VersionClock()
        self.buffers = [GhostPlane(self.clock, n, d, device)
                        for d in self.layer_dims]
        # lifetime accounting (plans may be generated ahead of execution;
        # the trainer sums CONSUMED plans for exact per-step reporting)
        self.steps_planned = 0
        self.total_bytes = 0
        self.total_rows = 0
        # telemetry: the halo path has no Transport (its traffic is priced
        # analytically per plan), so it feeds the shared comm_* series
        # directly, plus its own refresh/age/violation series
        lab = dict(path="halo", codec=self.codec.name)
        self._m_payload = telemetry.counter("comm_bytes_total",
                                            kind="payload", **lab)
        self._m_header = telemetry.counter("comm_bytes_total",
                                           kind="header", **lab)
        self._m_rows = telemetry.counter("comm_rows_total", **lab)
        self._m_refresh = telemetry.counter(
            "halo_refresh_rows_total",
            "ghost copies refreshed synchronously (all layers)")
        self._m_age = telemetry.histogram(
            "halo_ghost_age", "age (steps) refreshed ghost rows reached "
            "before refresh (first fills excluded)",
            buckets=telemetry.DEFAULT_COUNT_BUCKETS)
        self._m_viol = telemetry.counter(
            "halo_staleness_violations_total",
            "ghost rows left older than the bound after planning "
            "(structurally 0 — a nonzero value is a bug)")
        # graph-delta invalidations: per-layer ghost rows forced into the
        # next plan's must-refresh set regardless of the staleness bound
        self.delta_rows = 0
        self._m_delta = telemetry.counter(
            "delta_refresh_rows_total",
            "ghost buffer rows (per layer) force-refreshed because a "
            "graph delta touched their owners")

    # -- graph-delta invalidation ------------------------------------------
    def invalidate_rows(self, rows: np.ndarray) -> int:
        """Delta-aware invalidation: mark the given buffer rows (relabeled
        id space) never-written in EVERY layer buffer, so the next
        :meth:`plan_refresh` force-refreshes them regardless of the
        staleness bound ``S`` — a ghost whose owner a graph delta touched
        must never be served from history, however young.

        Rows outside the ghost set are ignored (they are nobody's ghost;
        nothing reads them remotely).  Invalidated rows land in the
        *must* set of the next plan, so the structural
        ``halo_staleness_violations_total == 0`` guarantee is preserved,
        and their refresh is excluded from the age histogram exactly
        like first fills (version ``NEVER`` carries no meaningful age).

        Returns the number of (row, layer) buffer entries invalidated,
        also counted into ``delta_refresh_rows_total``.
        """
        rows = np.asarray(rows, np.int64)
        n = len(self.copies)
        m = np.zeros(n, bool)
        m[rows[(rows >= 0) & (rows < n)]] = True
        m &= self.ghost_rows
        for buf in self.buffers:
            buf.invalidate(m)
        cnt = int(m.sum()) * len(self.buffers)
        self.delta_rows += cnt
        self._m_delta.inc(cnt)
        return cnt

    # -- refresh planning --------------------------------------------------
    def plan_refresh(self) -> RefreshPlan:
        """Decide (and account) this step's synchronous refresh set, stamp
        the refreshed rows at the current clock, and advance the clock.

        Returns the :class:`RefreshPlan` whose masks the jitted step
        consumes; the fresh values themselves are stored afterwards via
        :meth:`write_planes` (the split is what lets a host thread plan
        step ``t+1`` while the device still computes step ``t``).

        Guarantee: every ghost row NOT in the mask satisfies
        ``age <= max_staleness`` at this step — the bounded-staleness
        property the hypothesis tests assert.
        """
        now = self.clock.now
        budget = int(self.refresh_frac * self.n_ghost)
        masks, rows_moved, payload, headers = [], 0, 0, 0
        for buf, row_bytes in zip(self.buffers, self.row_wire_bytes):
            age = buf.age()
            must = self.ghost_rows & (age > self.max_staleness)
            mask = must.copy()
            extra = budget      # budget is per layer, on top of must rows
            if extra > 0:
                rest = self.ghost_rows & ~must
                idx = np.flatnonzero(rest)
                if len(idx):
                    oldest = idx[np.argsort(-age[idx], kind="stable")]
                    mask[oldest[:extra]] = True
            # telemetry: the age each refreshed row reached (first fills
            # from NEVER have no meaningful age) + the structural guard
            # that planning left no ghost row over the bound
            seen = mask & (buf.version != NEVER)
            self._m_age.observe_batch(age[seen])
            self._m_viol.inc(int((self.ghost_rows & ~mask
                                  & (age > self.max_staleness)).sum()))
            buf.version[mask] = now          # values arrive in write_planes
            masks.append(mask)
            rows_moved += int(self.copies[mask].sum())
            payload += int(self.copies[mask].sum()) * row_bytes
            headers += HEADER_BYTES * int(
                (self.member[:, mask].any(axis=1)).sum())
        self.clock.tick()
        self.steps_planned += 1
        self.total_rows += rows_moved
        self.total_bytes += payload + headers
        self._m_payload.inc(payload)
        self._m_header.inc(headers)
        self._m_rows.inc(rows_moved)
        self._m_refresh.inc(rows_moved)
        return RefreshPlan(now, masks, rows_moved, payload, headers)

    def write_planes(self, plan: RefreshPlan,
                     planes: Sequence[torch.Tensor]) -> None:
        """Store the step's freshly computed global layer outputs into the
        buffers, but only at the rows ``plan`` refreshed (everything else
        keeps its historical value and version).  Each plane's values
        change on the device; its versions were stamped by the plan.

        ``planes`` must already carry the *wire* values: under a lossy
        codec the step returns codec-decoded planes (it applies
        ``codec.qdq`` + error feedback in
        :func:`repro_torch.models.gnn.model.forward_stale`), so the
        buffers — and every subsequent stale read — see exactly what
        crossed the interconnect."""
        for buf, mask, plane in zip(self.buffers, plan.masks, planes):
            buf.set_rows(mask, plane)

    # -- views -------------------------------------------------------------
    def ghost_planes(self) -> List[torch.Tensor]:
        """Current (stale) per-layer global activation planes on the
        device, the tensors the step reads for non-refreshed ghost
        rows."""
        return [buf.values for buf in self.buffers]

    def sync_bytes_per_step(self) -> int:
        """Traffic a fully synchronous exchange (S=0, every ghost copy,
        every layer, every step) would move *under the active codec* —
        the baseline the staleness savings are measured against."""
        per_layer_rows = int(self.copies.sum())
        payload = sum(per_layer_rows * rb for rb in self.row_wire_bytes)
        headers = HEADER_BYTES * len(self.layer_dims) * int(
            (self.member.any(axis=1)).sum())
        return payload + headers

    def stats(self) -> dict:
        """Lifetime planning totals (may run ahead of executed steps when
        plans are prefetched; exact consumed numbers live in the trainer)."""
        steps = max(self.steps_planned, 1)
        return {
            "staleness": self.max_staleness,
            "refresh_frac": self.refresh_frac,
            "wire_codec": self.codec.name,
            "ghost_rows": self.n_ghost,
            "steps_planned": self.steps_planned,
            "refreshed_rows_total": self.total_rows,
            "delta_refresh_rows": self.delta_rows,
            "bytes_total": self.total_bytes,
            "bytes_per_step": self.total_bytes / steps,
            "sync_bytes_per_step": self.sync_bytes_per_step(),
        }
