"""Elastic replicated serving: router, autoscaler, rolling weight hot-swap.

The weights are a model (``nn.Module``, the ``init_gnn`` ModuleList); every
replica runs the first replica's forward callable, on the device the
weights live on.  On one card the replicas compute one after another and
the router lays their measured compute side by side in virtual time, so
N replicas model N cards: the fleet's p50 and p99 are virtual-clock
numbers, not what one card serves (its ``throughput_rps`` divides by the
host's wall time of the run, in which the replicas took turns).

The survey frames large-scale GNN serving as graph processing meeting
DL-systems operational machinery — replication, load balancing, elastic
scaling, and consistent model versioning.  This module is that tier on
top of the single :class:`~repro_torch.serving.server.GNNInferenceServer` loop:

* :class:`ReplicaRouter` — admits the workload under ONE virtual clock
  and dispatches each request to a replica (``round_robin`` or
  ``least_queue``).  Replicas overlap in virtual time (each is busy for
  its measured wall compute), so N replicas multiply simulated
  throughput; the router finalizes completions, tags every response with
  the weight version that computed it, and guarantees zero drops: every
  admitted request is dispatched, every dispatched request is served
  (draining replicas serve their queues dry before removal).
* :class:`AutoScaler` — KEDA-style load controller: scale up when queue
  depth per replica exceeds ``target_queue_per_replica`` or the recent
  p99 exceeds ``slo_p99_s``, scale down after sustained idleness, with a
  cooldown between actions and ``[min_replicas, max_replicas]`` bounds.
  The signals are the same queue-depth/latency series the telemetry
  plane exposes (``serving_replica_queue_depth``,
  ``serving_request_latency_seconds{replica=...}``).
* rolling hot-swap — :meth:`ReplicaRouter.hot_swap` stages
  ``(new_params, version+1)`` and the run loop flips replicas one at a
  time, each only while idle, so every batch is computed end-to-end
  under exactly one version.  Cache consistency under the swap:

  - *shared* cache: flipped (``bump_params_version`` → invalidate all
    planes + clock tick) when the FIRST replica upgrades; replicas still
    on the old version then see it as cold and neither read nor fill it
    (the version gate in ``GNNInferenceServer.serve_batch``), so a
    new-version reader can never receive old-version rows;
  - *private* caches: each replica's cache flips with the replica.

Stop/resume rides on :mod:`repro_torch.checkpoint`:
:meth:`ReplicaRouter.save` writes the current weights' ``state_dict`` and
version atomically (crash-safe temp-dir + rename), and
:func:`restore_params` loads the newest *complete* step into a copy of a
template model — a kill mid-save can only ever resurface the previous
version.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import telemetry
from repro_torch.core.telemetry import Histogram
from repro_torch.graph.structure import Graph
from repro_torch.models.gnn.model import GNNConfig
from repro_torch.serving.cache import EmbeddingCache
from repro_torch.serving.replica import ServingReplica
from repro_torch.serving.request import InferenceRequest, advance_vclock
from repro_torch.serving.server import GNNInferenceServer

__all__ = ["AutoscalePolicy", "AutoScaler", "ReplicaRouter", "RouterStats",
           "restore_params"]

ROUTER_POLICIES = ("round_robin", "least_queue")


@dataclasses.dataclass
class AutoscalePolicy:
    """Scaling thresholds (all times in *virtual* seconds).

    Scale up adds one replica when ``total_queue / n_replicas >
    target_queue_per_replica`` OR the windowed p99 exceeds ``slo_p99_s``
    (when set); scale down removes one after ``scale_down_after`` many
    consecutive low-load checks.  ``cooldown_s`` separates actions;
    ``startup_delay_s`` models a new replica's cold start (it accepts
    traffic immediately but cannot serve until the delay elapses)."""
    min_replicas: int = 1
    max_replicas: int = 8
    target_queue_per_replica: float = 8.0
    low_queue_per_replica: float = 0.5
    slo_p99_s: Optional[float] = None
    check_every_s: float = 0.02
    cooldown_s: float = 0.04
    scale_down_after: int = 3
    startup_delay_s: float = 0.0
    p99_window: int = 64


class AutoScaler:
    """Load-based replica-count controller over telemetry signals.

    :meth:`decide` consumes the fleet's current queue depths and the
    recent latency window and returns +1 (scale up), -1 (scale down), or
    0 — the router applies the action.  Decisions and their inputs are
    recorded in ``events`` for the benchmark/test assertions ("the
    autoscaler demonstrably scales up on queue depth")."""

    def __init__(self, policy: AutoscalePolicy):
        self.policy = policy
        self._last_action_s = -math.inf
        self._low_checks = 0
        self._recent: collections.deque = collections.deque(
            maxlen=policy.p99_window)
        self.events: List[dict] = []

    def observe_latency(self, latency_s: float) -> None:
        """Feed one completion latency into the p99 window."""
        self._recent.append(latency_s)

    def recent_p99(self) -> float:
        """p99 over the sliding completion window (0.0 while empty)."""
        if not self._recent:
            return 0.0
        return float(np.quantile(np.asarray(self._recent), 0.99))

    def decide(self, vnow: float, queue_depths: Sequence[int],
               n_replicas: int) -> int:
        """One control step; returns the replica-count delta."""
        p = self.policy
        if vnow - self._last_action_s < p.cooldown_s:
            return 0
        qpr = sum(queue_depths) / max(n_replicas, 1)
        p99 = self.recent_p99()
        up = qpr > p.target_queue_per_replica or (
            p.slo_p99_s is not None and p99 > p.slo_p99_s)
        if up and n_replicas < p.max_replicas:
            self._last_action_s = vnow
            self._low_checks = 0
            self.events.append({"vnow": vnow, "action": "up",
                                "queue_per_replica": qpr, "p99_s": p99,
                                "replicas": n_replicas + 1})
            return 1
        if qpr < p.low_queue_per_replica and not up:
            self._low_checks += 1
            if (self._low_checks >= p.scale_down_after
                    and n_replicas > p.min_replicas):
                self._last_action_s = vnow
                self._low_checks = 0
                self.events.append({"vnow": vnow, "action": "down",
                                    "queue_per_replica": qpr, "p99_s": p99,
                                    "replicas": n_replicas - 1})
                return -1
        else:
            self._low_checks = 0
        return 0


@dataclasses.dataclass
class RouterStats:
    """Fleet-level counters: completions, drops (structurally 0, asserted
    anyway), torn batches (> 1 weight version in one batch — structurally
    0, guarded in ``ServingReplica.try_serve``), per-version response
    counts, scale/swap event logs, and the merged latency distribution
    (always-on standalone histogram, same buckets as the per-replica
    telemetry series)."""
    served: int = 0
    batches: int = 0
    dropped: int = 0
    torn_batches: int = 0
    wall_s: float = 0.0
    dispatched: int = 0
    replicas_final: int = 0
    replicas_peak: int = 0
    hot_swaps: int = 0
    version_counts: Dict[int, int] = dataclasses.field(default_factory=dict)
    scale_events: List[dict] = dataclasses.field(default_factory=list)
    swap_events: List[dict] = dataclasses.field(default_factory=list)
    latency_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(
            "serving_request_latency_seconds",
            buckets=telemetry.DEFAULT_TIME_BUCKETS))

    @property
    def throughput_rps(self) -> float:
        """Completions per wall second (0.0, never NaN, on a zero wall)."""
        if not (self.wall_s > 0.0) or not math.isfinite(self.wall_s):
            return 0.0
        return self.served / self.wall_s

    def latency_quantile(self, q: float) -> float:
        """Merged-fleet latency quantile (0.0 on an empty histogram)."""
        v = self.latency_hist.quantile(q)
        return v if math.isfinite(v) else 0.0

    def summary(self) -> dict:
        return {
            "served": self.served,
            "batches": self.batches,
            "dropped": self.dropped,
            "torn_batches": self.torn_batches,
            "throughput_rps": self.throughput_rps,
            "p50_ms": self.latency_quantile(0.50) * 1e3,
            "p99_ms": self.latency_quantile(0.99) * 1e3,
            "replicas_final": self.replicas_final,
            "replicas_peak": self.replicas_peak,
            "hot_swaps": self.hot_swaps,
            "version_counts": {str(k): v
                               for k, v in sorted(self.version_counts.items())},
            "scale_events": len(self.scale_events),
        }


class ReplicaRouter:
    """Elastic multi-replica serving front end (one virtual clock).

    Args:
        g, cfg, params: served graph, model config, initial weights
            (version 0).
        n_replicas: initial fleet size.
        policy: dispatch policy — ``"round_robin"`` (rotate over active
            replicas) or ``"least_queue"`` (shortest queue wins, ties to
            the earlier-started batch / lower id).
        shared_cache: one :class:`EmbeddingCache` read and filled by all
            replicas (hits compound across the fleet) vs one private
            cache per replica (isolation; a new replica starts cold).
        cache_policy / cache_capacity / max_staleness / fanouts /
            buckets / max_wait_s / seed: forwarded to each replica's
            :class:`GNNInferenceServer`.
        autoscale: an :class:`AutoscalePolicy` to enable elastic scaling
            (``None`` = fixed fleet).

    :meth:`run` serves a workload to completion and returns
    :class:`RouterStats`; :meth:`hot_swap` stages a rolling weight
    upgrade the run loop applies replica-by-replica.
    """

    def __init__(self, g: Graph, cfg: GNNConfig, params, *,
                 n_replicas: int = 2,
                 policy: str = "least_queue",
                 shared_cache: bool = True,
                 cache_policy: str = "degree",
                 cache_capacity: Optional[int] = None,
                 max_staleness: int = 0,
                 fanouts: Sequence[int] = (5, 5),
                 buckets: Sequence[int] = (1, 4, 16, 64),
                 max_wait_s: float = 0.002,
                 seed: int = 0,
                 autoscale: Optional[AutoscalePolicy] = None):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"choose from {ROUTER_POLICIES}")
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.g = g
        self.cfg = cfg
        self.policy = policy
        self.params = params
        self.version = 0
        self._server_kw = dict(
            fanouts=tuple(fanouts), buckets=tuple(buckets),
            cache_policy=cache_policy, cache_capacity=cache_capacity,
            max_staleness=max_staleness, max_wait_s=max_wait_s, seed=seed)
        self.shared_cache: Optional[EmbeddingCache] = None
        if shared_cache and cache_policy != "none":
            self.shared_cache = EmbeddingCache(
                g, [cfg.hidden], policy=cache_policy,
                capacity=cache_capacity, max_staleness=max_staleness,
                codec=cfg.wire_codec)
        self.autoscaler = AutoScaler(autoscale) if autoscale else None
        self._forward = None          # first replica's forward, then shared
        self._next_rid = 0
        self.replicas: List[ServingReplica] = []
        # forward calls of replicas already reaped (see forward_calls)
        self._reaped_forward_calls = 0
        self._rr_next = 0             # round-robin cursor
        # pending rolling upgrade: (params, version, set of flipped rids)
        self._rollout: Optional[Tuple[object, int, set]] = None
        # last GraphUpdateLog sequence folded into the (shared) graph
        self._update_seq = 0
        self.stats = RouterStats()
        self._m_replicas = telemetry.gauge(
            "serving_replicas", "active replicas in the serving fleet")
        self._m_version = telemetry.gauge(
            "serving_params_version", "weight version at the router")
        self._m_dispatch: Dict[int, telemetry.Counter] = {}
        self._m_scale = {
            d: telemetry.counter("serving_scale_events_total",
                                 "autoscaler actions applied", direction=d)
            for d in ("up", "down")}
        self._m_swaps = telemetry.counter(
            "serving_hot_swaps_total", "completed rolling weight upgrades")
        for _ in range(n_replicas):
            self._add_replica(warm=True, reset_cache_stats=False)
        # one post-warmup reset per cache wipes compile-time traffic
        for cache in self._caches():
            cache.reset_stats()
        self._m_replicas.set(len(self.replicas))
        self._m_version.set(self.version)

    # -- fleet management --------------------------------------------------
    def _caches(self) -> List[EmbeddingCache]:
        if self.shared_cache is not None:
            return [self.shared_cache]
        return [r.server.cache for r in self.replicas]

    def _add_replica(self, *, warm: bool, reset_cache_stats: bool,
                     startup_until: float = 0.0) -> ServingReplica:
        rid = self._next_rid
        self._next_rid += 1
        srv = GNNInferenceServer(
            self.g, self.cfg, self.params, cache=self.shared_cache,
            params_version=self.version, forward_fn=self._forward,
            **self._server_kw)
        if self._forward is None:
            self._forward = srv._forward
        rep = ServingReplica(rid, srv)
        rep.busy_until = startup_until
        self.replicas.append(rep)
        if warm:
            rep.warmup(reset_cache_stats=reset_cache_stats)
        self.stats.replicas_peak = max(self.stats.replicas_peak,
                                       len(self.replicas))
        self._m_replicas.set(len(self.replicas))
        return rep

    @property
    def forward_calls(self) -> int:
        """Forward calls made by every replica this router has built,
        warmups and reaped replicas included (a run compares it with the
        aggregation kernels' launch counts)."""
        return self._reaped_forward_calls + sum(
            r.server.forward_calls for r in self.replicas)

    def _active(self) -> List[ServingReplica]:
        """Replicas eligible for new traffic (not draining)."""
        return [r for r in self.replicas if not r.draining]

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, req: InferenceRequest) -> None:
        active = self._active()
        assert active, "router invariant: at least one active replica"
        if self.policy == "round_robin":
            rep = active[self._rr_next % len(active)]
            self._rr_next += 1
        else:                          # least_queue
            rep = min(active,
                      key=lambda r: (r.queue_depth(), r.busy_until, r.rid))
        rep.dispatch(req)
        self.stats.dispatched += 1
        m = self._m_dispatch.get(rep.rid)
        if m is None:
            m = self._m_dispatch[rep.rid] = telemetry.counter(
                "serving_router_dispatch_total",
                "requests dispatched to replicas by the router",
                replica=str(rep.rid), policy=self.policy)
        m.inc()

    # -- rolling weight hot-swap -------------------------------------------
    def hot_swap(self, new_params, *, version: Optional[int] = None) -> int:
        """Stage a rolling upgrade to ``new_params``; returns the new
        version number.  The run loop flips replicas one at a time (each
        only while idle); call between runs or let ``hot_swap_every``
        trigger it mid-run.  Only one rollout may be in flight."""
        if self._rollout is not None:
            raise RuntimeError("a rolling upgrade is already in flight")
        v = self.version + 1 if version is None else version
        if v <= self.version:
            raise ValueError(f"version must grow: {self.version} -> {v}")
        self._rollout = (new_params, v, set())
        return v

    def _progress_rollout(self, vnow: float) -> None:
        """Advance the staged upgrade by at most ONE replica — genuinely
        rolling: the rest of the fleet keeps serving (on whichever
        version each is on) while one idle replica flips.  A replica
        mid-batch is skipped and flips on a later pass — its in-flight
        batch completes on the version it started on.  The shared cache
        flips with the FIRST replica; old-version replicas then bypass
        it entirely until their own flip."""
        if self._rollout is None:
            return
        params, v, flipped = self._rollout
        for rep in self.replicas:
            if rep.version >= v or not rep.idle(vnow):
                continue
            if self.shared_cache is not None and not flipped:
                self.shared_cache.bump_params_version(v)
            rep.swap(params, v)
            flipped.add(rep.rid)
            self.stats.swap_events.append(
                {"vnow": vnow, "replica": rep.rid, "version": v})
            break                      # one replica per pass
        # complete when every *current* replica serves v (replicas flipped
        # then drained/removed don't count; ones added mid-rollout must
        # still flip)
        if all(r.version >= v for r in self.replicas):
            self.params = params
            self.version = v
            self._rollout = None
            self.stats.hot_swaps += 1
            self._m_swaps.inc()
            self._m_version.set(v)

    # -- dynamic graphs ----------------------------------------------------
    def apply_graph_update(self, log, upto_seq: Optional[int] = None) -> dict:
        """Fold pending update-log events into the fleet's shared graph
        and invalidate every replica's dependent state: the graph arrays
        mutate IN PLACE exactly once (all replicas serve the same
        ``Graph`` object), each replica's sampler drops its touched
        memoized picks and rebuilds its reversed adjacency, and every
        cache — shared or per-replica — surgically invalidates the
        (L-1)-hop delta frontier.  Idempotent per sequence number; called
        between batches by the run loop (replicas are only ever flipped
        or invalidated while idle in virtual time)."""
        from repro_torch.core.updates import fold_in_place
        upto = log.last_seq if upto_seq is None else upto_seq
        if upto <= self._update_seq:
            return {"events": 0, "touched_nodes": 0,
                    "invalidated_rows": 0, "upto_seq": self._update_seq}
        hops = len(self._server_kw["fanouts"]) - 1
        delta, frontier = fold_in_place(
            self.g, log, self._update_seq, upto, hops=hops)
        for rep in self.replicas:
            rep.server.sampler.apply_delta(delta.nodes)
            rep.server._update_seq = upto
        n_inv = sum(c.invalidate_rows(frontier) for c in self._caches())
        self._update_seq = upto
        return {"events": delta.n_events,
                "touched_nodes": int(len(delta.nodes)),
                "invalidated_rows": n_inv,
                "upto_seq": upto}

    # -- autoscaling -------------------------------------------------------
    def _apply_autoscale(self, vnow: float) -> None:
        sc = self.autoscaler
        delta = sc.decide(vnow, [r.queue_depth() for r in self._active()],
                          len(self._active()))
        if delta > 0:
            # a private cache is brand new (safe to scrub its warmup
            # noise); a shared one carries fleet accounting — never reset
            self._add_replica(
                warm=True, reset_cache_stats=self.shared_cache is None,
                startup_until=vnow + sc.policy.startup_delay_s)
            self.stats.scale_events.append(sc.events[-1])
            self._m_scale["up"].inc()
        elif delta < 0:
            # drain the active replica with the least work outstanding;
            # it serves its queue dry, then the run loop removes it
            victim = min(self._active(),
                         key=lambda r: (r.queue_depth(), -r.rid))
            victim.draining = True
            self.stats.scale_events.append(sc.events[-1])
            self._m_scale["down"].inc()

    def _reap_drained(self, vnow: float) -> None:
        """Remove draining replicas whose queues are dry and whose last
        batch has completed — their requests were all served, so removal
        can never drop work."""
        keep = [r for r in self.replicas
                if not (r.draining and r.queue_depth() == 0 and r.idle(vnow))]
        self._reaped_forward_calls += sum(
            r.server.forward_calls for r in self.replicas if r not in keep)
        if len(keep) != len(self.replicas):
            self.replicas = keep
            self._m_replicas.set(len(keep))

    # -- the serve loop ----------------------------------------------------
    def run(self, workload: List[InferenceRequest], *,
            tick_every_s: float = 0.0,
            hot_swap_every: int = 0,
            new_params_fn: Optional[Callable[[int], object]] = None,
            update_log=None, update_every: int = 0,
            update_chunk: int = 0) -> RouterStats:
        """Serve ``workload`` to completion across the fleet.

        ``tick_every_s`` ages the caches on the shared virtual clock
        (feature-refresh epochs, as in the single server).
        ``hot_swap_every=K`` stages a rolling upgrade after every K
        completions — ``new_params_fn(version)`` supplies the weights
        (defaults to re-shipping the current ones, which still exercises
        the full version-flip machinery).  ``update_log`` streams graph
        mutations: after every ``update_every`` completions the next
        ``update_chunk`` pending events (0 = all pending) are folded via
        :meth:`apply_graph_update` — replicas invalidate mid-run, without
        a restart.  Returns the router stats; zero drops is asserted,
        not hoped for."""
        workload = sorted(workload, key=lambda r: r.arrival_s)
        vnow = 0.0
        i = 0
        served_at_last_swap = 0
        next_update = (update_every if update_log is not None
                       and update_every > 0 else math.inf)
        next_tick = tick_every_s if tick_every_s > 0 else math.inf
        sc = self.autoscaler
        next_check = sc.policy.check_every_s if sc else math.inf
        t_start = time.perf_counter()
        while i < len(workload) or any(r.queue_depth()
                                       for r in self.replicas):
            while vnow >= next_tick:
                for cache in self._caches():
                    cache.tick()
                next_tick += tick_every_s
            while i < len(workload) and workload[i].arrival_s <= vnow:
                self._dispatch(workload[i])
                i += 1
            drained = i >= len(workload)
            self._progress_rollout(vnow)
            if sc and vnow >= next_check:
                self._apply_autoscale(vnow)
                next_check = vnow + sc.policy.check_every_s
            progressed = False
            for rep in list(self.replicas):
                if not rep.idle(vnow):
                    continue
                out = rep.try_serve(vnow, force=drained)
                if out is None:
                    continue
                progressed = True
                mb, done = out
                versions = {r.params_version for r in mb.requests}
                if len(versions) > 1:
                    self.stats.torn_batches += 1
                for r in mb.requests:
                    self.stats.latency_hist.observe(r.latency_s)
                    self.stats.version_counts[r.params_version] = \
                        self.stats.version_counts.get(r.params_version, 0) + 1
                    if sc:
                        sc.observe_latency(r.latency_s)
                self.stats.served += len(mb.requests)
                self.stats.batches += 1
                if (hot_swap_every > 0 and self._rollout is None
                        and self.stats.served - served_at_last_swap
                        >= hot_swap_every):
                    self.hot_swap(new_params_fn(self.version + 1)
                                  if new_params_fn else self.params)
                    served_at_last_swap = self.stats.served
                if self.stats.served >= next_update:
                    upto = (None if update_chunk <= 0 else
                            min(self._update_seq + update_chunk,
                                update_log.last_seq))
                    self.apply_graph_update(update_log, upto)
                    next_update += update_every
            self._reap_drained(vnow)
            if progressed:
                continue
            # advance the virtual clock to the next event: an arrival, a
            # replica's in-flight completion, a head-of-line max-wait
            # deadline, a cache tick, or an autoscaler check — never
            # straight to the next arrival (queued work would stall)
            events = []
            if i < len(workload):
                events.append(workload[i].arrival_s)
            for rep in self.replicas:
                if rep.busy_until > vnow:
                    # a busy replica serves no earlier than its in-flight
                    # completion — an already-expired head-of-line
                    # deadline on its queue is NOT an event (it would pin
                    # the clock and spin the loop)
                    events.append(rep.busy_until)
                    continue
                oldest = rep.queue.oldest_arrival()
                if oldest is not None:
                    events.append(oldest + rep.server.batcher.max_wait_s)
            if next_tick != math.inf:
                events.append(next_tick)
            if sc and (i < len(workload)
                       or any(r.queue_depth() for r in self.replicas)):
                events.append(next_check)
            if not events:
                break
            # strict one-ulp progress (see request.advance_vclock: landing
            # exactly on fl(oldest + max_wait) would livelock a replica)
            vnow = advance_vclock(vnow, min(events))
        # finish any staged upgrade now that the fleet is idle (every
        # in-flight batch completed at its own version; one replica flips
        # per pass, so loop the rollout dry)
        v_end = max([vnow] + [r.busy_until for r in self.replicas])
        while self._rollout is not None:
            self._progress_rollout(v_end)
        if update_log is not None and update_log.last_seq > self._update_seq:
            # drain the stream: the fleet must finish caught up with every
            # event published before the run ended
            self.apply_graph_update(update_log)
        self._reap_drained(math.inf)
        self.stats.wall_s += time.perf_counter() - t_start
        self.stats.replicas_final = len(self.replicas)
        self.stats.dropped = (self.stats.dispatched - self.stats.served)
        assert self.stats.dropped == 0, (
            f"router dropped {self.stats.dropped} requests")
        return self.stats

    # -- stop/resume -------------------------------------------------------
    def save(self, directory: str) -> str:
        """Checkpoint the fleet's current weights (their ``state_dict``,
        copied to the host) + version atomically (crash-safe: see
        :mod:`repro_torch.checkpoint.io`); the step number IS the params
        version, so resume restores the newest complete version."""
        return save_checkpoint(directory, self.version,
                               {"params": self.params.state_dict()},
                               meta={"params_version": self.version,
                                     "policy": self.policy,
                                     "n_replicas": len(self.replicas)})

    def summary(self) -> dict:
        out = self.stats.summary()
        out["policy"] = self.policy
        out["shared_cache"] = self.shared_cache is not None
        out["params_version"] = self.version
        # cache stats: the shared cache's, or the per-replica merge
        caches = self._caches()
        if caches:
            hits = sum(c.hits for c in caches)
            misses = sum(c.misses for c in caches)
            out["embedding_hit_ratio"] = (
                hits / (hits + misses) if hits + misses else 0.0)
            out["feature_bytes"] = sum(c.features.transferred_bytes
                                       for c in caches)
            out["fill_bytes"] = sum(
                sum(t.total_bytes for t in c.fill.values()) for c in caches)
            out["wire_bytes"] = out["feature_bytes"] + out["fill_bytes"]
        out["replicas"] = [r.summary() for r in self.replicas]
        return out


def restore_params(directory: str, template) -> Tuple[object, int]:
    """Resume helper: load the newest *complete* checkpoint under
    ``directory`` into a copy of ``template`` (a model of the saved
    architecture, on the device to serve from) and return ``(params,
    params_version)``.  ``template`` itself is left as it was.  Partial
    steps (kill mid-save) are never candidates — ``latest_step`` skips
    them."""
    tree, manifest = load_checkpoint(directory,
                                     {"params": template.state_dict()})
    params = copy.deepcopy(template)
    params.load_state_dict(tree["params"])
    return params, int(manifest["meta"]["params_version"])
