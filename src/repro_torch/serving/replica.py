"""One serving replica: a `GNNInferenceServer` wrapped for router use.

The replicated serving tier (survey §3.2.2 — replication + load balancing
as the DL-serving lineage's answer to heavy traffic) splits the single
server's run loop in two: the
:class:`~repro_torch.serving.router.ReplicaRouter` owns admission,
dispatch, autoscaling, and the virtual clock, while each
:class:`ServingReplica` owns one private request queue, one batcher, and
one compute path (a full
:class:`~repro_torch.serving.server.GNNInferenceServer` minus its run
loop).

Replica lifecycle:

* ``ACTIVE``   — receives dispatched requests, forms and serves batches;
* ``DRAINING`` — scale-down target: receives nothing new, serves its
  queue dry, then is removed (zero dropped requests by construction);
* removed     — gone from the router's replica list.

Virtual-time semantics: a replica that starts a batch at virtual time
``t`` is busy until ``t + wall_compute`` (``busy_until``); replicas
overlap in virtual time even though the host executes them serially —
which is exactly how N replicas multiply simulated throughput.  On one
card the replicas run one after another, so N replicas model N cards,
not what one card serves.

Weight hot-swap happens *between* batches only (:meth:`swap` delegates to
``GNNInferenceServer.swap_params`` while idle), so every batch — and
therefore every request — is computed under exactly one
``(params, params_version, cache)`` and stamped with that version.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

from repro_torch.core import telemetry
from repro_torch.serving.batcher import MicroBatch
from repro_torch.serving.request import RequestQueue
from repro_torch.serving.server import GNNInferenceServer

__all__ = ["ServingReplica"]


class ServingReplica:
    """One replica: private queue + batcher + compute, router-scheduled.

    Args:
        rid: replica id (stable across the run; telemetry label).
        server: the wrapped single-node server.  Its ``run`` loop is
            never used — the router drives :meth:`serve` directly.

    The ``replica=<rid>`` telemetry series (``serving_requests_total``,
    ``serving_batches_total``, ``serving_request_latency_seconds``,
    ``serving_replica_queue_depth``) are this class's; the router adds
    the fleet-level ones (replica count, dispatch, scale/swap events).
    """

    def __init__(self, rid: int, server: GNNInferenceServer):
        self.rid = rid
        self.server = server
        self.queue = RequestQueue()
        # virtual time at which the in-flight batch (if any) completes
        self.busy_until = 0.0
        self.draining = False
        self.served = 0
        self.batches = 0
        lbl = str(rid)
        self._m_served = telemetry.counter(
            "serving_requests_total", "requests served to completion",
            replica=lbl)
        self._m_batches = telemetry.counter(
            "serving_batches_total", "micro-batches computed", replica=lbl)
        self._m_latency = telemetry.histogram(
            "serving_request_latency_seconds",
            "request latency, virtual-clock seconds (queueing + compute)",
            replica=lbl)
        self._m_queue = telemetry.gauge(
            "serving_replica_queue_depth",
            "requests queued at this replica", replica=lbl)

    # -- state -------------------------------------------------------------
    @property
    def version(self) -> int:
        """Weight version this replica currently serves."""
        return self.server.params_version

    def idle(self, vnow: float) -> bool:
        """True when no batch is in flight at virtual time ``vnow``."""
        return self.busy_until <= vnow

    def queue_depth(self) -> int:
        return len(self.queue)

    def dispatch(self, req) -> None:
        """Router handoff: enqueue one admitted request."""
        self.queue.push(req)
        self._m_queue.set(len(self.queue))

    # -- weight hot-swap ---------------------------------------------------
    def swap(self, params, version: int) -> None:
        """Flip to new weights; caller (the router's rolling upgrade)
        guarantees the replica is idle, so no in-flight batch can
        straddle the flip."""
        self.server.swap_params(params, version)

    # -- compute -----------------------------------------------------------
    def try_serve(self, vnow: float, *,
                  force: bool = False) -> Optional[Tuple[MicroBatch, float]]:
        """Form one batch from this replica's queue (per the batcher's
        emission policy; ``force`` drains at end of workload) and compute
        it.  Returns ``(batch, done_vtime)`` or ``None`` if no batch
        formed.  Completions are finalized here: each request gets its
        logits, completion stamp ``done_vtime = vnow + wall_compute``,
        and the single weight version that computed it."""
        srv = self.server
        mb = srv.batcher.form(self.queue, vnow, force=force)
        if mb is None:
            return None
        v0 = srv.params_version
        # anchor the server's virtual clock so spans inside serve_batch
        # land on the simulated axis (same contract as the single-server
        # run loop)
        srv._vnow, srv._vanchor = vnow, time.perf_counter()
        t0 = time.perf_counter()
        # serve_batch returns host arrays: its copy to the host waited
        # for the device, so dt includes the batch's device time
        logits = srv.serve_batch(mb)
        dt = time.perf_counter() - t0
        assert srv.params_version == v0, "params swapped mid-batch"
        done = vnow + dt
        self.busy_until = done
        for j, r in enumerate(mb.requests):
            r.logits = logits[mb.slots[j]]
            r.done_s = done
            r.params_version = v0
            srv.stats.latency_hist.observe(r.latency_s)
            self._m_latency.observe(r.latency_s)
        n = len(mb.requests)
        self.served += n
        self.batches += 1
        srv.stats.served += n
        srv.stats.batches += 1
        self._m_served.inc(n)
        self._m_batches.inc()
        self._m_queue.set(len(self.queue))
        return mb, done

    def warmup(self, *, reset_cache_stats: bool = True) -> None:
        """Run every declared bucket once (wall time only — virtual cold
        start is the router's ``startup_delay_s``).  Replicas added
        mid-run pass ``reset_cache_stats=False`` so warming up against a
        *shared* cache cannot wipe the fleet's accumulated accounting."""
        self.server.warmup(reset_cache_stats=reset_cache_stats)

    def summary(self) -> dict:
        return {
            "replica": self.rid,
            "served": self.served,
            "batches": self.batches,
            "version": self.version,
            "draining": self.draining,
        }
