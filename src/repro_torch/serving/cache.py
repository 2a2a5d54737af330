"""Layered historical-embedding cache for online GNN inference.

GNNAutoScale / VR-GCN idea (survey §3.2.4) applied at serving time: keep
the *layer outputs* ("historical embeddings") of hot vertices so a request
whose neighborhood is cached skips the entire sub-tree expansion below that
layer — neighbor sampling, feature fetches and aggregation all disappear
for hit nodes.

Consistency model (implemented by the shared
:class:`repro_torch.core.caching.VersionClock` / ``VersionedBuffer`` pair — the
same staleness substrate the training-side
:class:`repro_torch.core.halo.HaloExchange` uses):

* a global integer **version clock** advances on :meth:`tick` (one tick ≈
  one feature/model refresh epoch);
* an entry written at clock ``t`` has staleness ``clock - t``; entries with
  staleness > ``max_staleness`` are misses (bounded-staleness reads);
* :meth:`invalidate` drops entries for nodes whose input features changed,
  so staleness-0 reads are always exact.

Feature traffic accounting rides on :class:`repro_torch.core.caching.FeatureStore`
(the repo's existing byte-accounting substrate): the cache owns the store
and exposes combined hit/byte numbers.  Both the feature pulls and the
cache-*fill* payloads (freshly computed embedding rows shipped into the
cache) travel through the unified communication plane
(:mod:`repro_torch.core.comm`), so a ``bf16``/``int8`` wire codec compresses —
and byte-accounts — every remote row the server moves.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.caching import (CACHE_POLICIES, NEVER, FeatureStore,
                                      VersionClock, VersionedBuffer)
from repro_torch.core.comm import Transport, WireCodec
from repro_torch.graph.structure import Graph

__all__ = ["EmbeddingCache", "NEVER"]


class EmbeddingCache:
    """Bounded-staleness historical-embedding cache for serving.

    Args:
        g: the served graph (features may be mutated via
           :meth:`update_features`).
        layer_dims: width of each cached plane — one per cached layer
            output (the server caches the final-layer input, so one plane
            of width ``hidden``).
        policy: admission policy name from
            :data:`repro_torch.core.caching.CACHE_POLICIES`.
        capacity: admitted-node budget; ``None`` = whole graph, ``0`` is
            honored as "admit nothing".
        max_staleness: entries older than this many clock ticks are misses.
        feature_capacity: budget of the input-feature
            :class:`FeatureStore` layer (defaults to ``capacity``).
        codec: wire codec for remote payloads — both the feature pulls
            and the cache-fill rows written via :meth:`store` (which are
            stored *as decoded*, so hits serve exactly what crossed the
            wire).  ``fp32`` (default) is bit-exact with the pre-codec
            behavior.

    Shape conventions: every lookup/store is *slot-aligned* over a padded
    id vector (``-1`` = empty slot).  Padded slots are neither hits nor
    misses and are never written, so batch shapes stay static.
    """

    def __init__(self, g: Graph, layer_dims: Sequence[int], *,
                 policy: str = "degree", capacity: Optional[int] = None,
                 max_staleness: int = 0,
                 feature_capacity: Optional[int] = None,
                 codec: Union[str, WireCodec] = "fp32"):
        self.g = g
        self.max_staleness = max_staleness
        self.vclock = VersionClock()
        n = g.num_nodes
        # None = unbounded (whole graph); 0 is honored as "admit nothing"
        capacity = n if capacity is None else capacity
        admit_ids = CACHE_POLICIES[policy](g, capacity)
        # memory is bounded by the ADMITTED set, not the graph: planes hold
        # one row per admitted node plus a sacrificial row (index ``rows-1``)
        # that absorbs reads for non-admitted ids and is never written
        self.slot = np.full(n, -1, np.int64)
        self.slot[admit_ids] = np.arange(len(admit_ids))
        rows = len(admit_ids) + 1
        self.planes: Dict[int, VersionedBuffer] = {
            l: VersionedBuffer(self.vclock, rows, d)
            for l, d in enumerate(layer_dims)}
        # cache fills are remote transfers too: one channel per plane,
        # error-feedback residuals keyed by cache slot; all planes share
        # the "serving.fill" telemetry path
        self.fill: Dict[int, Transport] = {
            l: Transport(codec, n_rows=rows, path="serving.fill")
            for l in range(len(layer_dims))}
        # input-feature cache (PaGraph/AliGraph layer of the hierarchy)
        if feature_capacity is None:
            feature_capacity = capacity
        self.features = FeatureStore(
            g, CACHE_POLICIES[policy](g, feature_capacity), codec=codec,
            path="serving.features")
        self.hits = 0
        self.misses = 0
        # rows dropped by incremental (delta-driven) invalidation — the
        # counter the dynamic-graph bench compares against full flushes
        self.invalidated_rows = 0
        # model-weight version whose outputs the planes currently hold.
        # Readers on a different params version must treat the cache as
        # cold (see GNNInferenceServer.serve_batch) — mixing embeddings
        # produced by two weight versions inside one batch is the
        # "version-torn" hazard rolling hot-swap exists to prevent.
        self.params_version = 0
        self._m_hits = telemetry.counter(
            "cache_lookups_total", cache="serving.embedding", result="hit")
        self._m_misses = telemetry.counter(
            "cache_lookups_total", cache="serving.embedding", result="miss")
        self._m_invalidated = telemetry.counter(
            "cache_invalidated_rows_total",
            "embedding rows dropped by incremental (delta-driven) "
            "invalidation", cache="serving.embedding")

    @property
    def clock(self) -> int:
        """Current value of the shared version clock."""
        return self.vclock.now

    def bump_params_version(self, version: int) -> None:
        """Atomically flip the cache to a new model-weight version: every
        plane is invalidated wholesale (embeddings computed under the old
        weights are wrong at any staleness) and the version clock ticks
        once, all before ``params_version`` is published — so no reader
        can ever pair new-version freshness with old-version rows.
        Idempotent per version; rejects going backwards."""
        if version == self.params_version:
            return
        if version < self.params_version:
            raise ValueError(
                f"params version must be monotone: have "
                f"{self.params_version}, got {version}")
        for plane in self.planes.values():
            plane.invalidate_all()
        self.vclock.tick()
        self.params_version = version

    # -- embedding plane ---------------------------------------------------
    def lookup(self, layer: int, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Slot-aligned bounded-staleness read.

        Args:
            layer: cached plane index.
            ids: ``(B,)`` node ids, ``-1`` = padded slot.

        Returns:
            ``(values, fresh)`` — ``values`` is ``(B, dim)`` (garbage rows
            where not fresh), ``fresh`` marks slots served from cache
            within the staleness bound.  Padded slots are neither hits nor
            misses.
        """
        ids = np.asarray(ids)
        valid = ids >= 0
        plane = self.planes[layer]
        slot = self.slot[np.maximum(ids, 0)]
        row = np.where(slot >= 0, slot, plane.rows - 1)
        fresh = valid & plane.fresh_mask(self.max_staleness, row)
        self.hits += int(fresh.sum())
        self.misses += int((valid & ~fresh).sum())
        self._m_hits.inc(int(fresh.sum()))
        self._m_misses.inc(int((valid & ~fresh).sum()))
        return plane.values[row], fresh

    def store(self, layer: int, ids: np.ndarray, values: np.ndarray,
              mask: np.ndarray) -> None:
        """Write freshly computed rows for admitted nodes (slot-aligned;
        ``mask`` selects which slots to write).  Non-admitted and padded
        slots are silently skipped.  The written rows are a cache-*fill*
        transfer: they cross the communication plane (codec-encoded,
        byte-accounted) and the plane stores the decoded wire values."""
        ids = np.asarray(ids)
        write = np.asarray(mask, bool) & (ids >= 0)
        write &= self.slot[np.maximum(ids, 0)] >= 0
        rows = self.slot[ids[write]]
        vals = self.fill[layer].send(np.asarray(values)[write],
                                     row_ids=rows)
        self.planes[layer].write(rows, vals)

    # -- consistency -------------------------------------------------------
    def tick(self, n: int = 1) -> None:
        """Advance the version clock (a feature/model refresh epoch)."""
        self.vclock.tick(n)

    def invalidate(self, ids: np.ndarray) -> None:
        """Drop entries for nodes whose input features changed — their
        historical embeddings are wrong at any staleness."""
        ids = np.asarray(ids)
        rows = self.slot[ids[ids >= 0]]
        rows = rows[rows >= 0]
        for plane in self.planes.values():
            plane.invalidate(rows)

    def invalidate_rows(self, node_ids: np.ndarray, *,
                        tick: bool = True) -> int:
        """Incremental (delta-driven) invalidation: age exactly the rows
        of ``node_ids`` to ``NEVER`` across every plane — untouched rows
        keep their versions and stay servable within the staleness
        bound.  This is the surgical alternative to
        :meth:`bump_params_version`'s all-or-nothing flush: a graph
        delta only poisons the frontier it reaches, so only that
        frontier pays a recompute.

        ``tick`` (default) advances the shared clock once — a delta fold
        is a refresh epoch, so the write that re-fills an invalidated
        row is stamped strictly after the invalidation (the ordering the
        "never serve pre-invalidation values" property asserts).

        Returns the number of admitted cache rows invalidated (ids
        outside the admitted set cost nothing and count nothing).
        """
        ids = np.asarray(node_ids, np.int64)
        ids = ids[(ids >= 0) & (ids < len(self.slot))]
        rows = np.unique(self.slot[ids])
        rows = rows[rows >= 0]
        for plane in self.planes.values():
            plane.invalidate(rows)
        n = int(len(rows))
        self.invalidated_rows += n
        self._m_invalidated.inc(n)
        if tick:
            self.vclock.tick()
        return n

    def update_features(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Feature update path: mutate the store and invalidate dependents.
        (1-hop dependents would need graph traversal; serving treats a
        feature epoch as a tick, which ages ALL entries — the per-node
        invalidation here handles the updated nodes exactly.)"""
        self.g.features[ids] = rows
        self.invalidate(ids)
        self.tick()

    # -- stats -------------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the embedding hit/miss counters, the feature layer's
        stats, and every cache-fill transport — with the matching
        telemetry series reset in lockstep.  The one warmup-exclusion
        entry point: callers must use this instead of assigning
        ``cache.hits``/``cache.features.hits`` (cached values and
        error-feedback residuals are kept — they are state, not
        accounting)."""
        self.hits = 0
        self.misses = 0
        self.invalidated_rows = 0
        self._m_hits.reset()
        self._m_misses.reset()
        self._m_invalidated.reset()
        self.features.reset_stats()
        for t in self.fill.values():
            t.reset_counters()

    @property
    def hit_ratio(self) -> float:
        """Fraction of non-padded lookups served within the bound."""
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    def stats(self) -> dict:
        """Combined embedding + feature-layer counters for summaries."""
        fill_bytes = sum(t.total_bytes for t in self.fill.values())
        return {
            "embedding_hit_ratio": self.hit_ratio,
            "embedding_hits": self.hits,
            "embedding_misses": self.misses,
            "invalidated_rows": self.invalidated_rows,
            "feature_hit_ratio": self.features.hit_ratio,
            "feature_bytes": self.features.transferred_bytes,
            "fill_bytes": fill_bytes,
            "wire_bytes": self.features.transferred_bytes + fill_bytes,
            "wire_codec": self.features.codec.name,
            "clock": self.clock,
        }
