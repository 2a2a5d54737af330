"""Staleness-bounded asynchronous full-graph training (survey §3.2.7).

Full-graph training where boundary ("ghost") activations are exchanged
with *bounded staleness* instead of a synchronous halo exchange every
layer — the PipeGCN / DistGNN / SANCUS recipe that hides communication
behind compute.  One process a rank, over the collectives of
:mod:`repro_torch.core.collectives`.

Composition of existing pieces:

* :class:`repro_torch.core.halo.HaloExchange` — versioned per-layer ghost
  buffers under the shared :class:`repro_torch.core.caching.VersionClock`
  (the same staleness implementation serving's ``EmbeddingCache`` uses);
  every rank holds the same replicated exchange and makes the same plans
  (checked at the end of every :meth:`AsyncFullGraphTrainer.run`);
* :func:`repro_torch.models.gnn.model.forward_stale` — the GCN forward
  that aggregates historical activations for non-refreshed ghosts;
* :class:`~repro_torch.distributed.pipeline.HostPrefetcher` — the refresh
  *plan* for step ``t+1`` (mask selection, version stamping, byte
  accounting) is produced on a host thread while step ``t`` computes.

Semantics per step ``t`` with bound ``S`` and budget ``F``:

1. the planner marks every ghost row whose staleness would exceed ``S``
   (plus the oldest ``F``-fraction of the rest) for *synchronous* refresh;
2. the step computes with fresh activations for owned + refreshed rows
   and historical buffer values for everything else;
3. refreshed rows' freshly gathered values are written back to the
   buffers (on the device), stamped with the step's clock value.

``S = 0`` forces every ghost row into every plan, degrading to the
synchronous pull step of
:func:`repro_torch.core.propagation.make_distributed_gcn_step` (up to the
order of one product: this step multiplies after the gather).  Larger
``S`` strictly reduces cross-partition bytes/step (each row crosses the
wire at most every ``S+1`` steps).

Orthogonally, ``cfg.wire_codec`` compresses what DOES cross the wire
through the unified communication plane (:mod:`repro_torch.core.comm`):
ghost refreshes are quantized in-step (``bf16`` rounding or ``int8``
per-row affine + error-feedback residuals), the historical buffers store
the decoded wire values, and every plan prices rows at the codec's wire
size.  The bytes of the plans are the algorithm's; the collectives move
every row of every gathered plane (their own counters say how many).
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.core import telemetry
from repro_torch.core.comm import resolve_codec
from repro_torch.core.halo import HaloExchange, build_halo
from repro_torch.core.partitioning import EdgeCutPartition
from repro_torch.core.propagation import (ShardedGraph, label_count,
                                          local_loss, rank_shard,
                                          shard_graph, sum_grads_and_loss)
from repro_torch.distributed.pipeline import HostPrefetcher
from repro_torch.graph.structure import Graph
from repro_torch.models.gnn import model as GM
from repro_torch.models.gnn.model import GNNConfig


def exchange_for_shards(g: Graph, sg: ShardedGraph,
                        layer_dims: Sequence[int], *,
                        max_staleness: int = 0, refresh_frac: float = 0.0,
                        codec="fp32", clock=None,
                        device="cpu") -> HaloExchange:
    """Build the :class:`HaloExchange` matching a ``ShardedGraph``.

    ``shard_graph`` relabels vertices to contiguous per-rank ranges, so
    ownership is recoverable as ``perm[v] // n_local``; the halo layout is
    computed in original ids and the exchange buffers live in the padded
    relabeled space the step indexes into, on ``device``.

    Args:
        g: the original graph.
        sg: the sharded layout built from it.
        layer_dims: widths of the buffered layer outputs (``[hidden] *
            (num_layers - 1)`` for the GCN stack).
        max_staleness / refresh_frac / codec / clock / device: forwarded
            to :class:`HaloExchange` (``codec`` selects the wire format
            of the ghost refresh payloads).
    """
    part = EdgeCutPartition(
        assignment=(sg.perm // sg.n_local).astype(np.int64),
        n_parts=sg.n_dev)
    layout = build_halo(g, part)
    return HaloExchange(layout, layer_dims, max_staleness=max_staleness,
                        refresh_frac=refresh_frac, relabel=sg.perm,
                        n_rows=sg.n_local * sg.n_dev, codec=codec,
                        clock=clock, device=device)


def make_async_fullgraph_step(optimizer, *, codec="fp32"):
    """Build one rank's staleness-bounded full-graph GCN step::

        train_step(params, shard, ghosts, refresh, residuals=(), x_all=None)
            -> (loss, planes, residuals)

    ``shard`` is the rank's pull-layout
    :class:`~repro_torch.core.propagation.RankShard`; ``ghosts`` the
    per-layer ``(N_pad, F_l)`` stale activation planes (replicated, on
    the device); ``refresh`` the per-layer ``(N_pad,)`` bool refresh
    masks; ``planes`` the layer outputs *as they crossed the wire*
    (codec-decoded; exact fp32 under the identity codec) to write back;
    ``residuals`` the per-layer error-feedback state (pass ``()`` under
    the identity codec).  ``loss`` is summed over the ranks; the
    gradients are summed and ``optimizer`` steps on every rank, as in
    :func:`repro_torch.core.propagation.make_distributed_gcn_step`.
    ``codec`` selects the communication-plane wire format."""
    codec = resolve_codec(codec)
    quantize = not codec.identity

    def train_step(params, shard, ghosts: Sequence[torch.Tensor],
                   refresh: Sequence[torch.Tensor],
                   residuals: Sequence[torch.Tensor] = (), x_all=None):
        rows = torch.arange(shard.n_pad, device=shard.x.device)
        own_rows = (rows // shard.n_local) == shard.rank
        cnt = label_count(shard)
        optimizer.zero_grad(set_to_none=True)
        h, planes, res_out = GM.forward_stale(
            params, shard.x, shard, ghosts, refresh, own_rows,
            codec=codec if quantize else None,
            residuals=residuals if quantize else None, x_all=x_all)
        loss = local_loss(h, shard, cnt)
        loss.backward()
        total = sum_grads_and_loss(params, loss)
        optimizer.step()
        return total, planes, res_out

    return train_step


class AsyncFullGraphTrainer:
    """One rank's driver of staleness-bounded asynchronous full-graph
    training, inside a :mod:`repro_torch.core.collectives` world.

    Owns the sharded layout, the :class:`HaloExchange` and the step;
    :meth:`run` overlaps refresh planning with device compute via
    :class:`~repro_torch.distributed.pipeline.HostPrefetcher` and keeps
    exact consumed-plan traffic accounting.

    Args:
        g: the training graph (features + labels required).
        cfg: GCN config (``arch="gcn"``; the full-graph path is
            GCN-specific, like the synchronous one).
        optimizer: a torch optimizer built on the params :meth:`run` gets.
        n_dev: the world size (one partition per rank).
        partitioner: edge-cut method name (``hash``/``ldg``/``fennel``).
        staleness: bound ``S`` — a ghost activation may be up to ``S``
            steps old; ``0`` = synchronous halo exchange.
        refresh_frac: extra per-step refresh budget (fraction of ghosts).
        device: this rank's device.

    ``cfg.wire_codec`` selects the communication-plane wire format of the
    ghost refresh payloads (``fp32`` is exact; ``bf16``/``int8``
    compress, with int8 carrying sender-side error-feedback residuals
    through the step).  The static input features are all-gathered once
    per layout (the same bits as once per step).
    """

    def __init__(self, g: Graph, cfg: GNNConfig, optimizer, n_dev: int, *,
                 partitioner: str = "hash", staleness: int = 0,
                 refresh_frac: float = 0.0, device="cpu"):
        if cfg.arch != "gcn":
            raise ValueError("async full-graph training implements GCN "
                             "(like the synchronous distributed path)")
        if n_dev != C.world_size():
            raise ValueError(f"{n_dev} partitions in a world of "
                             f"{C.world_size()} ranks")
        self.g = g
        self.cfg = cfg
        self.n_dev = n_dev
        self.rank = C.rank()
        self.device = torch.device(device)
        self.partitioner = partitioner
        self.codec = resolve_codec(cfg.wire_codec)
        self.sg = shard_graph(g, n_dev, method=partitioner)
        layer_dims = [cfg.hidden] * (cfg.num_layers - 1)
        self.exchange = exchange_for_shards(
            g, self.sg, layer_dims, max_staleness=staleness,
            refresh_frac=refresh_frac, codec=self.codec, device=self.device)
        self.step = make_async_fullgraph_step(optimizer, codec=self.codec)
        self._place()
        self.steps_run = 0
        self.consumed_bytes = 0
        self.consumed_rows = 0
        self._update_seq = 0
        self.losses: List[float] = []
        # per-step host / device time and the collectives' share
        self.clock = C.StepClock(self.device)
        self._m_step = telemetry.histogram(
            "train_step_seconds", "wall time per executed training step",
            buckets=telemetry.DEFAULT_TIME_BUCKETS,
            mode="fullgraph_async")

    def _place(self) -> None:
        """This rank's shard of the current layout, the gathered inputs
        and zero error-feedback residuals (they price rows of the layout
        they were made for)."""
        self.shard = rank_shard(self.sg, self.rank, self.device)
        self.x_all = C.all_gather(self.shard.x)
        self._residuals = (tuple(
            torch.zeros((self.sg.n_pad, d), dtype=torch.float32,
                        device=self.device)
            for d in self.exchange.layer_dims)
            if self.codec.error_feedback else ())

    # -- dynamic graphs ----------------------------------------------------
    def fold_updates(self, log, upto_seq=None) -> dict:
        """Continual training: fold pending
        :class:`repro_torch.core.updates.GraphUpdateLog` events into the
        training graph between epochs, WITHOUT a cold restart.

        The graph arrays mutate in place, the sharded layout is rebuilt
        (edge deltas change the padded edge lists; ``hash`` keeps the
        same node assignment, ``ldg``/``fennel`` may re-balance), and the
        :class:`HaloExchange` is rebuilt on the SAME version clock with
        every buffer row ported by node id — so untouched ghost rows
        keep their values and version stamps.  Rows owned by the
        ``(num_layers-1)``-hop delta frontier are then invalidated: the
        next plan force-refreshes exactly them, regardless of the bound
        S, so a stale read never spans a graph mutation.

        The step is reused as-is.  Error-feedback residuals are reset to
        zero.  Idempotent per sequence number.  Every rank folds the same
        events the same way.  Returns a fold summary dict."""
        from repro_torch.core.updates import fold_in_place
        upto = log.last_seq if upto_seq is None else upto_seq
        if upto <= self._update_seq:
            return {"events": 0, "touched_nodes": 0,
                    "invalidated_rows": 0, "upto_seq": self._update_seq}
        delta, frontier = fold_in_place(
            self.g, log, self._update_seq, upto,
            hops=self.cfg.num_layers - 1)
        old_sg, old_ex = self.sg, self.exchange
        self.sg = shard_graph(self.g, self.n_dev, method=self.partitioner)
        self.exchange = exchange_for_shards(
            self.g, self.sg, old_ex.layer_dims,
            max_staleness=old_ex.max_staleness,
            refresh_frac=old_ex.refresh_frac, codec=self.codec,
            clock=old_ex.clock, device=self.device)
        # port buffer state by NODE id: perm maps original id -> padded
        # row, so row contents and version stamps follow each node across
        # any re-partition; rows nothing maps to keep NEVER (cold)
        new_rows = torch.from_numpy(self.sg.perm).to(self.device)
        old_rows = torch.from_numpy(old_sg.perm).to(self.device)
        for new_buf, old_buf in zip(self.exchange.buffers, old_ex.buffers):
            new_buf.values[new_rows] = old_buf.values[old_rows]
            new_buf.version[self.sg.perm] = old_buf.version[old_sg.perm]
        n_inv = self.exchange.invalidate_rows(self.sg.perm[frontier])
        self._place()
        self._update_seq = upto
        return {"events": delta.n_events,
                "touched_nodes": int(len(delta.nodes)),
                "invalidated_rows": n_inv,
                "upto_seq": upto}

    # -- training loop -----------------------------------------------------
    def run(self, params, epochs: int, *, log_every: int = 0,
            prefetch_plans: bool = True) -> float:
        """Train ``epochs`` full-graph steps of ``params`` (updated in
        place); returns the last loss.

        The planner produces exactly ``epochs`` refresh plans (then
        ``None`` sentinels), so version stamps and byte accounting
        correspond one-to-one to executed steps even though planning runs
        ahead on the prefetch thread.  At the end every rank's plans are
        checked to be the same."""
        produced = {"n": 0}

        def next_plan():
            if produced["n"] >= epochs:
                return None              # sentinel: planner budget spent
            produced["n"] += 1
            return self.exchange.plan_refresh()

        planner = HostPrefetcher(next_plan) if prefetch_plans else None
        loss = float("nan")
        try:
            for epoch in range(epochs):
                plan = next(planner) if planner else next_plan()
                with self.clock.step():
                    masks = [torch.from_numpy(m).to(self.device)
                             for m in plan.masks]
                    # residuals are instance state (carried through the
                    # step so the wire planes it returns are exactly what
                    # receivers decode, and preserved across run() calls)
                    total, planes, res = self.step(
                        params, self.shard, self.exchange.ghost_planes(),
                        masks, self._residuals, x_all=self.x_all)
                    if self.codec.error_feedback:
                        self._residuals = res
                    self.exchange.write_planes(plan, planes)
                    loss = float(total)         # waits for the step
                self.losses.append(loss)
                self._m_step.observe(self.clock.rows[-1]["wall_s"])
                self.steps_run += 1
                self.consumed_bytes += plan.bytes
                self.consumed_rows += plan.rows_moved
                if log_every and (epoch % log_every == 0
                                  or epoch == epochs - 1):
                    print(f"epoch {epoch:3d} loss {loss:.4f} "
                          f"refresh_rows {plan.rows_moved} "
                          f"bytes {plan.bytes}")
        finally:
            if planner is not None:
                planner.close()
        C.check_same(self.plan_digest(), "the halo refresh plans")
        return loss

    # -- evaluation / reporting --------------------------------------------
    def plan_digest(self) -> bytes:
        """A digest of every buffer row's version stamp and the planned
        totals: equal on every rank that made the same plans."""
        h = hashlib.sha256()
        for buf in self.exchange.buffers:
            h.update(buf.version.tobytes())
        h.update(np.array([self.exchange.total_bytes,
                           self.exchange.total_rows,
                           self.exchange.clock.now], np.int64).tobytes())
        return h.digest()

    def ghost_digest(self) -> str:
        """A digest of the ghost planes' values (their bytes on the
        host): ranks that hold the same planes bit for bit agree."""
        h = hashlib.sha256()
        for plane in self.exchange.ghost_planes():
            h.update(plane.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def accuracy(self, params) -> float:
        """Full-graph accuracy of ``params`` on this rank's device (exact,
        no staleness — the number the accuracy-gap benchmark reports)."""
        from repro_torch.core.abstraction import DeviceGraph
        dg = DeviceGraph.from_graph(self.g, self.device)
        with torch.no_grad():
            logits = GM.forward_full(
                self.cfg, params, dg,
                torch.from_numpy(self.g.features).to(self.device))
            return float(GM.accuracy(
                logits, torch.from_numpy(self.g.labels).to(self.device)))

    def stats(self) -> dict:
        """Consumed-plan traffic + timing, with the synchronous baseline
        for savings reporting."""
        steps = max(self.steps_run, 1)
        sync = self.exchange.sync_bytes_per_step()
        per_step = self.consumed_bytes / steps
        return {
            "staleness": self.exchange.max_staleness,
            "refresh_frac": self.exchange.refresh_frac,
            "wire_codec": self.codec.name,
            "steps": self.steps_run,
            "ghost_rows": self.exchange.n_ghost,
            "bytes_per_step": per_step,
            "rows_per_step": self.consumed_rows / steps,
            "sync_bytes_per_step": sync,
            "comm_savings": 1.0 - per_step / sync if sync else 0.0,
            "mean_step_s": (sum(r["wall_s"] for r in self.clock.rows)
                            / steps),
        }
