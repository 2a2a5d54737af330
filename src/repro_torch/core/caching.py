"""Feature caching / inter-process communication policies (survey §3.2.4,
Table 6) plus the shared bounded-staleness version clock.

The surveyed systems cut host→device (PaGraph) or remote-machine (AliGraph)
feature traffic by caching features of vertices likely to be touched:

* :func:`degree_cache` — PaGraph: pre-sort by out-degree, fill the cache
  top-down ("a higher out-degree vertex is an in-neighbor of more nodes,
  hence sampled more often").
* :func:`importance_cache` — AliGraph: cache vertices whose importance
  (k-hop in/out-neighbor ratio) exceeds a threshold.
* :func:`no_cache` — baseline.

``FeatureStore`` plays the role of DistDGL's KVStore: a global store that
serves features and counts the bytes that would cross the interconnect —
the quantity the caching claims in EXPERIMENTS.md §Paper-validation are
measured on.  Remote rows travel through one
:class:`repro_torch.core.comm.Transport` (the unified communication plane), so
the wire format — and therefore both the returned values and the byte
accounting — follows the selected :class:`~repro_torch.core.comm.WireCodec`
(``fp32`` identity by default; ``bf16``/``int8`` compress).

:class:`VersionClock` / :class:`VersionedBuffer` are the *one* staleness
implementation in the repo: the serving
:class:`~repro_torch.serving.cache.EmbeddingCache` (GNNAutoScale historical
embeddings at inference time) and the training
:class:`~repro_torch.core.halo.HaloExchange` (staleness-bounded asynchronous
full-graph halos) both read and write through them, so "an entry written
at clock ``v`` may be served while ``clock - v <= max_staleness``" means
exactly the same thing on both paths.
"""
from __future__ import annotations

from typing import Iterable, Optional, Union

import numpy as np

# HEADER_BYTES is canonically defined by the communication plane
# (re-exported here for the subsystems that historically imported it
# from caching)
from repro_torch.core import telemetry
from repro_torch.core.comm import (HEADER_BYTES, QuantizedRows, Transport,
                                   WireCodec)
from repro_torch.graph.structure import Graph

# sentinel version for "never written"; large-negative (not int64 min) so
# computing ``clock - NEVER`` cannot overflow int64
NEVER = -(2 ** 62)


class VersionClock:
    """A global integer clock shared by every staleness-bounded buffer.

    One :meth:`tick` ≈ one refresh epoch (a serving feature/model refresh,
    or one asynchronous full-graph training step).  Buffers attached to
    the same clock age together — the property the cross-subsystem
    staleness tests key off.
    """

    def __init__(self) -> None:
        self.now = 0

    def tick(self, n: int = 1) -> None:
        """Advance the clock by ``n`` epochs (``n >= 1``)."""
        self.now += int(n)


class VersionedBuffer:
    """One plane of values with a per-row version under a shared clock.

    Args:
        clock: the shared :class:`VersionClock` this plane ages against.
        rows:  number of value rows (fixed; shapes never change).
        dim:   feature width of each row.
        dtype: row dtype (default float32).

    Invariants:
        * a row written at clock ``v`` has age ``clock.now - v``;
        * :meth:`fresh_mask` marks rows with ``age <= max_staleness`` —
          never-written rows (version ``NEVER``) are never fresh;
        * :meth:`write` stamps rows with the *current* clock value.
    """

    def __init__(self, clock: VersionClock, rows: int, dim: int,
                 dtype=np.float32) -> None:
        self.clock = clock
        self.values = np.zeros((rows, dim), dtype)
        self.version = np.full(rows, NEVER, np.int64)

    @property
    def rows(self) -> int:
        return len(self.version)

    def age(self, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-row staleness ``clock.now - version`` (huge for never-written
        rows).  ``rows`` selects a subset; default is every row."""
        v = self.version if rows is None else self.version[rows]
        return self.clock.now - v

    def fresh_mask(self, max_staleness: int,
                   rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Bounded-staleness read predicate: True where the row may be
        served without violating the bound."""
        return self.age(rows) <= max_staleness

    def write(self, rows: np.ndarray, values: np.ndarray) -> None:
        """Store ``values`` at ``rows`` and stamp them with the current
        clock (``rows`` may be an index array or a boolean mask)."""
        self.values[rows] = values
        self.version[rows] = self.clock.now

    def invalidate(self, rows: np.ndarray) -> None:
        """Mark rows never-written: they fail every staleness bound until
        the next :meth:`write` (inputs changed ⇒ history is wrong at any
        staleness)."""
        self.version[rows] = NEVER

    def invalidate_all(self) -> None:
        """Mark the whole plane never-written — the producing model (or
        feature epoch) changed wholesale, so every row's history is wrong
        at any staleness (rolling weight hot-swap uses this to flip a
        serving cache to a new params version atomically)."""
        self.version[:] = NEVER


class FeatureStore:
    """Global feature server + device-side cache with traffic accounting.

    Args:
        g: graph whose ``features`` are served (``(N, F)`` float32; a
            feature-less graph serves row ids instead).
        cache_ids: node ids admitted to the device-side cache (hits are
            free; misses are charged ``bytes_per_row`` each plus one
            ``HEADER_BYTES`` envelope per fetch call that moves rows).
        codec: wire codec for remote rows (``fp32`` default is bit-exact
            and keeps the historical raw-float accounting; ``bf16`` /
            ``int8`` shrink ``bytes_per_row`` and return the receiver's
            decoded view of every miss row).
        path: telemetry label for this store's transfer path — names
            both its :class:`~repro_torch.core.comm.Transport` channel
            (``comm_*`` series) and its
            ``cache_lookups_total{cache=<path>,result=hit|miss}``
            counters in :mod:`repro_torch.core.telemetry`.

    Shape convention: :meth:`fetch_masked` is slot-aligned over padded id
    vectors (``-1`` = pad slot) and returns zero rows at unneeded slots,
    so batch shapes stay static and pad rows can never aggregate.
    """

    def __init__(self, g: Graph, cache_ids: np.ndarray, *,
                 codec: Union[str, WireCodec] = "fp32",
                 path: str = "features"):
        self.g = g
        self.cached = np.zeros(g.num_nodes, bool)
        self.cached[cache_ids] = True
        self.transport = Transport(codec, n_rows=g.num_nodes, path=path)
        self.codec = self.transport.codec
        self.bytes_per_row = (
            self.codec.wire_bytes_per_row(g.features.shape[1])
            if g.features is not None else 4)
        self.hits = 0
        self.misses = 0
        self._m_hits = telemetry.counter(
            "cache_lookups_total", "cache lookups by result",
            cache=path, result="hit")
        self._m_misses = telemetry.counter(
            "cache_lookups_total", cache=path, result="miss")

    @property
    def requests(self) -> int:
        """Remote pull RPCs actually issued (one envelope each)."""
        return self.transport.requests

    def _pull_remote(self, rows: np.ndarray,
                     ids: np.ndarray) -> np.ndarray:
        """Ship miss rows through the communication plane: accounts one
        RPC (payload + header) and returns the wire-decoded rows."""
        return self.transport.send(rows, row_ids=ids)

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """Fetch feature rows for ``ids`` (pads dropped); cache misses
        cross the wire (codec-encoded + accounted), hits are local."""
        ids = np.asarray(ids)
        ids = ids[ids >= 0]
        hit = self.cached[ids]
        self.hits += int(hit.sum())
        self._m_hits.inc(int(hit.sum()))
        miss = ~hit
        miss_rows = int(miss.sum())
        self.misses += miss_rows
        self._m_misses.inc(miss_rows)
        if self.g.features is None:
            if miss_rows:
                self.transport.account_opaque(miss_rows, 4)
            return ids
        out = self.g.features[ids]          # fancy indexing: fresh copy
        if miss_rows:
            out[miss] = self._pull_remote(out[miss], ids[miss])
        return out

    def _local_rows_mask(self, safe_ids: np.ndarray,
                         needed: np.ndarray) -> np.ndarray:
        """Hook: needed rows served from local memory — no cache lookup,
        no traffic.  The base store owns nothing locally; the distributed
        ``PartitionFeatureStore`` overrides this with partition ownership."""
        return np.zeros(len(safe_ids), bool)

    def fetch_masked(self, ids: np.ndarray, needed: np.ndarray) -> np.ndarray:
        """Slot-aligned fetch for padded serving batches: ``ids`` may
        contain -1 pads and ``needed`` marks the slots whose features are
        actually required (the rest return zero rows, keeping the batch
        shape static).  Only needed non-local rows count toward traffic,
        and a call whose mask selects no rows (or only local/cache hits)
        issues no remote request — it adds 0 bytes, not a header."""
        ids = np.asarray(ids)
        needed = np.asarray(needed, bool) & (ids >= 0)
        safe = np.maximum(ids, 0)
        remote = needed & ~self._local_rows_mask(safe, needed)
        hit = self.cached[safe] & remote
        self.hits += int(hit.sum())
        self._m_hits.inc(int(hit.sum()))
        miss = remote & ~hit
        miss_rows = int(miss.sum())
        self.misses += miss_rows
        self._m_misses.inc(miss_rows)
        if self.g.features is None:
            if miss_rows:
                self.transport.account_opaque(miss_rows, 4)
            return safe
        out = np.zeros((len(ids), self.g.features.shape[1]),
                       self.g.features.dtype)
        out[needed] = self.g.features[safe[needed]]
        if miss_rows:
            out[miss] = self._pull_remote(out[miss], safe[miss])
        return out

    def fetch_masked_wire(self, ids: np.ndarray,
                          needed: np.ndarray) -> QuantizedRows:
        """:meth:`fetch_masked` in the int8 wire format: identical slot
        alignment, hit/miss accounting, and traffic charges, but the
        result stays quantized (:class:`QuantizedRows`) so the caller
        can feed the int8-in/fp32-accumulate kernel directly.

        Miss rows arrive via :meth:`Transport.send_wire` (charged, with
        error feedback); local/hit rows are encoded in place — they
        never cross the wire, so they cost nothing, but the batch is
        uniformly quantized (each row within the codec's scale/2 error
        bound of its fp32 value).  Unneeded/pad slots carry
        ``q = mn = scale = 0`` and dequantize to exact zero rows,
        matching :meth:`fetch_masked`.  Requires the int8 codec."""
        if self.codec.name != "int8":
            raise ValueError(
                f"fetch_masked_wire requires the int8 codec (store has "
                f"{self.codec.name!r})")
        if self.g.features is None:
            raise ValueError("fetch_masked_wire needs a feature matrix")
        ids = np.asarray(ids)
        needed = np.asarray(needed, bool) & (ids >= 0)
        safe = np.maximum(ids, 0)
        remote = needed & ~self._local_rows_mask(safe, needed)
        hit = self.cached[safe] & remote
        self.hits += int(hit.sum())
        self._m_hits.inc(int(hit.sum()))
        miss = remote & ~hit
        miss_rows = int(miss.sum())
        self.misses += miss_rows
        self._m_misses.inc(miss_rows)
        F = self.g.features.shape[1]
        q = np.zeros((len(ids), F), np.uint8)
        mn = np.zeros((len(ids), 1), np.float32)
        scale = np.zeros((len(ids), 1), np.float32)
        local = needed & ~miss
        if int(local.sum()):
            enc = self.codec.encode(
                np.asarray(self.g.features[safe[local]], np.float32))
            q[local], mn[local], scale[local] = enc.data
        if miss_rows:
            wire = self.transport.send_wire(
                np.asarray(self.g.features[safe[miss]], np.float32),
                row_ids=safe[miss])
            q[miss], mn[miss], scale[miss] = wire.q, wire.mn, wire.scale
        return QuantizedRows(q, mn, scale)

    def reset_stats(self) -> None:
        """Zero hit/miss counters and the transport's traffic counters
        (error-feedback residuals are kept).  The telemetry series are
        reset in lockstep so exposed metrics keep matching these
        counters — the warmup-exclusion entry point (callers must not
        poke ``hits``/``misses`` directly)."""
        self.hits = 0
        self.misses = 0
        self._m_hits.reset()
        self._m_misses.reset()
        self.transport.reset_counters()

    @property
    def hit_ratio(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    @property
    def transferred_bytes(self) -> int:
        """Bytes the communication plane moved: miss-row payloads at the
        codec's wire size plus one ``HEADER_BYTES`` envelope per RPC."""
        return self.transport.total_bytes


def no_cache(g: Graph, capacity: int) -> np.ndarray:
    """Baseline policy: admit nothing (every remote row is traffic)."""
    return np.zeros(0, np.int64)


def degree_cache(g: Graph, capacity: int) -> np.ndarray:
    """PaGraph policy: top-``capacity`` vertices by out-degree."""
    order = np.argsort(-g.out_degree(), kind="stable")
    return order[:capacity]


def importance_cache(g: Graph, capacity: int, *, hops: int = 1) -> np.ndarray:
    """AliGraph policy: importance = in-neighbor count / out-neighbor count
    (vertices whose neighbors are needed by many, cheap to keep)."""
    imp = (g.in_degree() + 1.0) / (g.out_degree() + 1.0)
    # AliGraph caches the *out-neighbors of important vertices*; rank
    # vertices by combined score so the budget holds the hot set.
    score = imp * np.maximum(g.out_degree(), 1)
    order = np.argsort(-score, kind="stable")
    return order[:capacity]


def random_cache(g: Graph, capacity: int, *, seed: int = 0) -> np.ndarray:
    """Uniform-random admission — the control the policy claims are
    measured against."""
    rng = np.random.default_rng(seed)
    return rng.choice(g.num_nodes, min(capacity, g.num_nodes), replace=False)


CACHE_POLICIES = {
    "none": no_cache,
    "degree": degree_cache,      # PaGraph
    "importance": importance_cache,  # AliGraph
    "random": random_cache,
}


def measure_cache(g: Graph, policy: str, capacity: int,
                  batches: Iterable[np.ndarray]) -> dict:
    """Replay input-node id streams from a sampler against a cache policy."""
    ids = CACHE_POLICIES[policy](g, capacity)
    store = FeatureStore(g, ids)
    for b in batches:
        store.fetch(b)
    return {"policy": policy, "capacity": capacity,
            "hit_ratio": store.hit_ratio,
            "transferred_mb": store.transferred_bytes / 2**20}
