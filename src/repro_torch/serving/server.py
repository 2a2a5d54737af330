"""The GNN inference server: admit → micro-batch → sample → cache → forward.

Control flow per micro-batch (bucket B, L layers):

1. the batcher pads B seed slots (-1 = empty) — one of the declared
   bucket shapes;
2. the outer (final-layer) block is always sampled fresh;
3. historical embeddings for the outer block's src slots are looked up in
   the :class:`EmbeddingCache`; only *misses* are expanded further down
   and only miss-path input features are fetched (zero rows elsewhere —
   shapes stay static);
4. one forward (a plain callable on device tensors, run under
   ``torch.inference_mode()``) computes the miss rows, splices cached
   rows in, applies the final layer, and returns fresh rows for
   write-back.  On a CUDA device its aggregations are the hand-written
   Hopper kernels.

The clock is virtual: requests carry synthetic arrival stamps and the
server advances time by the measured wall-clock compute of each batch, so
p50/p99 include queueing delay and the run is reproducible.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.abstraction import DeviceGraph
from repro_torch.core.telemetry import Histogram
from repro_torch.core.updates import fold_in_place
from repro_torch.graph.structure import Graph
from repro_torch.models.gnn import model as GM
from repro_torch.models.gnn.model import GNNConfig
from repro_torch.serving.batcher import BucketedBatcher, MicroBatch
from repro_torch.serving.cache import EmbeddingCache
from repro_torch.serving.request import (InferenceRequest, RequestQueue,
                                         advance_vclock)
from repro_torch.serving.sampler import ServingSampler, needed_feature_mask


def _latency_hist() -> Histogram:
    """Standalone (always-on) latency histogram backing ``ServeStats`` —
    p50/p99 must work whether or not global telemetry is enabled, so this
    one is not attached to the registry."""
    return Histogram("serving_request_latency_seconds",
                     buckets=telemetry.DEFAULT_TIME_BUCKETS)


@dataclasses.dataclass
class ServeStats:
    """Serve-loop counters: requests served, batches formed, wall time,
    per-request latency distribution (virtual-clock seconds, a telemetry
    :class:`~repro_torch.core.telemetry.Histogram` — the one quantile
    implementation in the repo), and the set of distinct forward shapes
    (``len(jit_shapes)``, reported as ``jit_entries`` like the
    reference's jit cache — ≤ one entry per declared bucket)."""
    served: int = 0
    batches: int = 0
    wall_s: float = 0.0
    latency_hist: Histogram = dataclasses.field(default_factory=_latency_hist)
    jit_shapes: set = dataclasses.field(default_factory=set)

    @property
    def throughput_rps(self) -> float:
        """Served requests per second of elapsed time; 0.0 (never NaN/inf,
        never a raise) when no time has elapsed — a zero-elapsed run with
        served requests is degenerate, not infinitely fast."""
        if not (self.wall_s > 0.0) or not math.isfinite(self.wall_s):
            return 0.0
        return self.served / self.wall_s

    @property
    def latencies_s(self) -> List[float]:
        """Recorded per-request latencies in observation order (a uniform
        subsample once the histogram's reservoir saturates)."""
        return [float(v) for v in self.latency_hist.samples]

    def latency_quantile(self, q: float) -> float:
        """Latency quantile (numpy-style interpolation, via the shared
        telemetry histogram); 0.0 on an empty histogram — an unserved
        stats object reports zero latency, it does not raise."""
        v = self.latency_hist.quantile(q)
        return v if math.isfinite(v) else 0.0

    def summary(self) -> dict:
        return {
            "served": self.served,
            "batches": self.batches,
            "throughput_rps": self.throughput_rps,
            "p50_ms": self.latency_quantile(0.50) * 1e3,
            "p99_ms": self.latency_quantile(0.99) * 1e3,
            "jit_entries": len(self.jit_shapes),
        }


class GNNInferenceServer:
    """The online GNN inference server: admit → micro-batch → sample →
    cache → forward (see module docstring for the per-batch control flow).

    Args:
        g: served graph (features required).
        cfg: model config (any sampled arch with ``num_layers >= 2``;
            appnp is full-graph and rejected).
        params: the model for ``cfg`` (the ``nn.ModuleList`` of
            :func:`~repro_torch.models.gnn.model.init_gnn`); the server
            runs on the device its parameters live on.
        fanouts: per-layer sampling fanouts (one per model layer).
        buckets: declared batch-size vocabulary (static shapes — at most
            one forward shape per bucket, asserted via ``jit_entries``).
        cache_policy / cache_capacity / max_staleness: admission policy,
            budget, and staleness bound of the historical-embedding
            :class:`EmbeddingCache` (``"none"`` disables write-back).
        cache: inject an externally owned :class:`EmbeddingCache` instead
            of building a private one — the replicated serving tier's
            *shared-cache* mode, where N replicas read and fill one
            cache (``cache_policy``/``cache_capacity`` are then ignored).
        max_wait_s: head-of-line batching deadline.
        seed: sampling determinism base.
        params_version: integer weight version served; :meth:`swap_params`
            flips ``(params, params_version)`` atomically between batches
            and the cache is only consulted while its ``params_version``
            matches — one batch can never mix two weight versions.
        forward_fn: a shared forward callable (replicas of one
            deployment); defaults to :func:`forward_blocks_cached`.

    :meth:`run` serves a workload under a virtual clock (arrival stamps +
    measured compute), so p50/p99 include queueing delay and runs are
    reproducible; :meth:`summary` merges latency, cache, and pad stats.
    """

    def __init__(self, g: Graph, cfg: GNNConfig, params, *,
                 fanouts: Sequence[int] = (5, 5),
                 buckets: Sequence[int] = (1, 4, 16, 64),
                 cache_policy: str = "degree",
                 cache_capacity: Optional[int] = None,
                 max_staleness: int = 0,
                 cache: Optional[EmbeddingCache] = None,
                 max_wait_s: float = 0.002,
                 seed: int = 0,
                 params_version: int = 0,
                 forward_fn=None):
        if cfg.arch == "appnp":
            raise ValueError("appnp serves full-graph; use a sampled arch")
        if len(fanouts) != cfg.num_layers:
            raise ValueError("need one fanout per layer")
        if cfg.num_layers < 2:
            raise ValueError("serving path assumes >= 2 layers (the "
                             "historical plane caches the final-layer input)")
        self.g = g
        self.cfg = cfg
        self.params = params
        self.params_version = params_version
        self.device = next(params.parameters()).device
        self.sampler = ServingSampler(g, fanouts, seed=seed)
        self.batcher = BucketedBatcher(buckets, max_wait_s=max_wait_s)
        # one cached plane: the (post-relu) hidden state entering the
        # final layer — dimension ``hidden`` for every arch in the zoo.
        # cfg.wire_codec selects the communication-plane wire format for
        # feature pulls AND cache fills (fp32 = bit-exact default).
        if cache is not None:
            if cache.planes[0].values.shape[1] != cfg.hidden:
                raise ValueError("injected cache plane width != cfg.hidden")
            self.use_cache = True
            self.owns_cache = False
            self.cache = cache
        else:
            self.use_cache = cache_policy != "none"
            self.owns_cache = True
            self.cache = EmbeddingCache(
                g, [cfg.hidden], policy=cache_policy,
                capacity=cache_capacity, max_staleness=max_staleness,
                codec=cfg.wire_codec)
            self.cache.params_version = params_version
        self._forward = forward_fn if forward_fn is not None else (
            lambda p, inner, outer, x, ch, fm: GM.forward_blocks_cached(
                cfg, p, inner, outer, x, ch, fm))
        self.stats = ServeStats()
        # forward calls made, warmup included (a run compares it with the
        # aggregation kernels' launch counts)
        self.forward_calls = 0
        # last GraphUpdateLog sequence number folded into self.g — the
        # cursor apply_graph_update() advances (monotone, idempotent)
        self._update_seq = 0
        # what each apply_graph_update call folded (its returned dict)
        self.folds: List[dict] = []
        # telemetry plane (no-ops unless repro_torch.core.telemetry is enabled)
        self._m_queue = telemetry.gauge(
            "serving_queue_depth", "admitted requests waiting to batch")
        self._m_occupancy = telemetry.histogram(
            "serving_batch_occupancy", "real requests per formed batch",
            buckets=telemetry.DEFAULT_COUNT_BUCKETS)
        self._m_latency = telemetry.histogram(
            "serving_request_latency_seconds",
            "request latency, virtual-clock seconds (queueing + compute)")
        self._m_served = telemetry.counter(
            "serving_requests_total", "requests served to completion")
        self._m_batches = telemetry.counter(
            "serving_batches_total", "micro-batches computed")
        # virtual clock: _vnow advances by the measured wall compute of
        # each batch (see run()); between updates, virtual time flows at
        # wall rate from the anchor — which is what lets tracer spans
        # carry simulated timestamps consistent with reported p50/p99
        self._vnow = 0.0
        self._vanchor = time.perf_counter()

    def _virtual_now(self) -> float:
        """Current virtual-clock reading (the span clock): the last
        run-loop virtual time plus wall progress since its anchor."""
        return self._vnow + (time.perf_counter() - self._vanchor)

    def swap_params(self, params, version: int) -> None:
        """Atomically flip this server to new weights.  Called only
        between batches (the replica router guarantees the replica is
        idle), so every batch — including ones whose requests were queued
        before the flip — is computed end-to-end under exactly one
        ``(params, params_version, cache state)``.  A privately owned
        cache is flipped in the same breath; a shared cache is flipped
        once by whoever owns the rollout (see ``ReplicaRouter``)."""
        if version < self.params_version:
            raise ValueError(
                f"params version must be monotone: have "
                f"{self.params_version}, got {version}")
        self.params = params
        self.params_version = version
        if self.owns_cache:
            self.cache.bump_params_version(version)

    # -- dynamic graphs ----------------------------------------------------
    def apply_graph_update(self, log, upto_seq: Optional[int] = None, *,
                           flush: bool = False) -> dict:
        """Fold pending
        :class:`repro_torch.core.updates.GraphUpdateLog` events into the
        served graph IN PLACE and incrementally invalidate every
        dependent state:

        * the sampler drops memoized picks of touched nodes and rebuilds
          its reversed adjacency (untouched nodes keep their exact
          previous expansion);
        * the embedding cache surgically invalidates the (L-1)-hop
          frontier of the delta — the cached plane is the FINAL-layer
          input, which depends on a node's (L-1)-hop sampled ball, so any
          node whose ball the delta can reach is aged to ``NEVER`` while
          everything else stays hot.

        The frontier is the union of pre- and post-mutation adjacency
        (a removed edge poisons the neighborhoods it used to feed).
        Idempotent per sequence number: re-applying an already-folded
        prefix is a no-op.  Called only between batches (same contract as
        :meth:`swap_params`).

        ``flush=True`` is the rebuild-on-schedule BASELINE the dynamic
        bench compares against: instead of the surgical frontier, every
        admitted cache row is invalidated on every fold — including folds
        with zero pending events, since a system without delta tracking
        cannot know nothing changed.

        Returns what was folded (events, touched nodes, invalidated cache
        rows, the new cursor); each call's dict is also kept in
        ``self.folds``."""
        upto = log.last_seq if upto_seq is None else upto_seq
        if upto <= self._update_seq:
            n_inv = (self.cache.invalidate_rows(np.arange(self.g.num_nodes))
                     if flush and self.use_cache else 0)
            self.folds.append({"events": 0, "touched_nodes": 0,
                               "invalidated_rows": n_inv,
                               "upto_seq": self._update_seq})
            return self.folds[-1]
        hops = len(self.sampler.fanouts) - 1
        delta, frontier = fold_in_place(
            self.g, log, self._update_seq, upto, hops=hops)
        self.sampler.apply_delta(delta.nodes)
        if not self.use_cache:
            n_inv = 0
        elif flush:
            n_inv = self.cache.invalidate_rows(np.arange(self.g.num_nodes))
        else:
            n_inv = self.cache.invalidate_rows(frontier)
        self._update_seq = upto
        self.folds.append({"events": delta.n_events,
                           "touched_nodes": int(len(delta.nodes)),
                           "invalidated_rows": n_inv, "upto_seq": upto})
        return self.folds[-1]

    # -- one micro-batch ---------------------------------------------------
    def serve_batch(self, mb: MicroBatch) -> np.ndarray:
        """Returns (bucket, num_classes) logits (padded slots garbage)."""
        vclock = self._virtual_now
        # the cache is readable only while it holds THIS weight version's
        # embeddings — mid-rollout, a replica still on the old weights
        # sees a flipped shared cache as cold (and must not fill it, or a
        # new-version replica would read old-version rows: a torn batch)
        cache_ok = (self.use_cache
                    and self.cache.params_version == self.params_version)
        with telemetry.span("serve.batch", clock=vclock, bucket=mb.bucket):
            with telemetry.span("serve.sample", clock=vclock):
                outer_b = self.sampler.sample_outer(mb.node_ids)
                ids1 = outer_b.src_nodes
                if cache_ok:
                    cached_h, fresh = self.cache.lookup(0, ids1)
                else:
                    cached_h = np.zeros((len(ids1), self.cfg.hidden),
                                        np.float32)
                    fresh = np.zeros(len(ids1), bool)
                miss = (ids1 >= 0) & ~fresh
                inner_bs = self.sampler.sample_inner(ids1, expand=miss)
                need = needed_feature_mask(inner_bs, miss)
                x_in = self.cache.features.fetch_masked(
                    inner_bs[0].src_nodes, need)

            inner_dev = [DeviceGraph.from_block(b, self.device)
                         for b in inner_bs]
            outer_dev = DeviceGraph.from_block(outer_b, self.device)
            shape_key = (mb.bucket,
                         tuple((b.num_dst, b.num_src, len(b.edge_mask))
                               for b in inner_bs + [outer_b]))
            self.stats.jit_shapes.add(shape_key)

            with telemetry.span("serve.forward", clock=vclock), \
                    torch.inference_mode():
                logits, h_fresh = self._forward(
                    self.params, inner_dev, outer_dev, self._put(x_in),
                    self._put(cached_h), self._put(fresh))
                # the copy to the host waits for the device: it ends the
                # timed forward
                logits = logits.cpu().numpy()
            self.forward_calls += 1
            if cache_ok:
                self.cache.store(0, ids1, h_fresh.cpu().numpy(), miss)
        return logits

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def warmup(self, node_id: int = 0, *,
               reset_cache_stats: bool = True) -> None:
        """Run every declared bucket once (excluded from stats): on a CUDA
        device this builds the kernels and makes their first launches, so
        neither lands in the stats.
        ``reset_cache_stats=False`` keeps the cache counters — replicas
        warmed mid-run against a *shared* cache must not wipe the
        fleet's accumulated accounting."""
        for b in self.batcher.buckets:
            ids = np.full((b,), -1, np.int64)
            ids[0] = node_id
            self.serve_batch(MicroBatch([], ids, b, 0.0))
        # warmup traffic must not pollute serving stats: the caches own
        # their counters (and the matching telemetry series), so reset
        # through them instead of poking their attributes
        if reset_cache_stats:
            self.cache.reset_stats()

    # -- the serve loop ----------------------------------------------------
    def run(self, workload: List[InferenceRequest], *,
            tick_every_s: float = 0.0,
            update_log=None, update_every: int = 0,
            update_chunk: int = 0) -> ServeStats:
        """Serve a workload to completion.  ``tick_every_s`` simulates
        periodic feature-refresh epochs: every interval of virtual time the
        cache's version clock advances, aging historical embeddings — the
        staleness bound then decides whether they can still be served.

        ``update_log`` streams live graph mutations into the run: after
        every ``update_every`` completed requests the next ``update_chunk``
        pending events (0 = all pending) are folded via
        :meth:`apply_graph_update` — between batches, so no batch ever
        straddles a mutation."""
        workload = sorted(workload, key=lambda r: r.arrival_s)
        queue = RequestQueue()
        vnow = 0.0
        next_tick = tick_every_s if tick_every_s > 0 else float("inf")
        next_update = (update_every if update_log is not None
                       and update_every > 0 else float("inf"))
        i = 0
        t_start = time.perf_counter()
        while i < len(workload) or len(queue):
            while vnow >= next_tick:
                self.cache.tick()
                next_tick += tick_every_s
            while i < len(workload) and workload[i].arrival_s <= vnow:
                queue.push(workload[i])
                i += 1
            drained = i >= len(workload)
            self._m_queue.set(len(queue))
            mb = self.batcher.form(queue, vnow, force=drained)
            if mb is None:
                # jump to the next event: an arrival, the head-of-line
                # request's max_wait deadline, or a cache-clock tick —
                # NOT straight to the next arrival, which would make
                # queued requests wait a full inter-arrival gap
                events = []
                if i < len(workload):
                    events.append(workload[i].arrival_s)
                oldest = queue.oldest_arrival()
                if oldest is not None:
                    events.append(oldest + self.batcher.max_wait_s)
                if next_tick != float("inf"):
                    events.append(next_tick)
                # strict one-ulp progress (see request.advance_vclock:
                # landing exactly on fl(oldest + max_wait) would livelock)
                vnow = advance_vclock(vnow, min(events))
                continue
            # anchor the virtual clock: during this batch's compute,
            # virtual time = vnow + wall elapsed (exactly how vnow itself
            # advances below), so spans inside serve_batch land on the
            # same simulated axis as the reported latencies
            self._vnow, self._vanchor = vnow, time.perf_counter()
            t0 = time.perf_counter()
            logits = self.serve_batch(mb)
            vnow += time.perf_counter() - t0
            self._vnow = vnow
            self._m_occupancy.observe(len(mb.requests))
            for j, r in enumerate(mb.requests):
                r.logits = logits[mb.slots[j]]
                r.done_s = vnow
                r.params_version = self.params_version
                self.stats.latency_hist.observe(r.latency_s)
                self._m_latency.observe(r.latency_s)
            self._m_served.inc(len(mb.requests))
            self._m_batches.inc()
            self.stats.served += len(mb.requests)
            self.stats.batches += 1
            if self.stats.served >= next_update:
                upto = (None if update_chunk <= 0 else
                        min(self._update_seq + update_chunk,
                            update_log.last_seq))
                self.apply_graph_update(update_log, upto)
                next_update += update_every
        if update_log is not None and update_log.last_seq > self._update_seq:
            # drain the stream: a run must leave the served graph caught
            # up with every event published before it finished
            self.apply_graph_update(update_log)
        self.stats.wall_s += time.perf_counter() - t_start
        return self.stats

    def summary(self) -> dict:
        out = self.stats.summary()
        out.update(self.cache.stats())
        out["pad_overhead"] = self.batcher.pad_overhead
        return out
