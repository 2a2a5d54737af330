"""Distributed full-graph message propagation (survey §3.2.6 / §2.2.5).

The survey's push/pull taxonomy maps onto collectives exactly:

* **pull** (GAS/GraphLab/DGL): each rank *pulls* the current features of
  all source vertices — an all-gather over the ranks, then a local
  gather + segment-reduce onto its own destinations (K1 over ``N_pad``
  sources and ``n_local`` destinations).
* **push** (Pregel/NeuGraph): each rank computes its local sources'
  contributions to *every* destination and *pushes* partial aggregates —
  K1 over ``n_local`` sources and ``N_pad`` destinations, then a
  reduce-scatter onto the destination owners.

Both compute the same aggregation; they differ in where the reduction
happens and what crosses the wire (features vs partial aggregates).
DistGNN's delayed-aggregate mode (§3.2.7) is the pull variant with a
stale feature cache refreshed every ``s`` steps.

The reference runs this under ``shard_map`` over mesh axis ``"g"``; here
every function is one rank's part, one process a rank, over the
collectives of :mod:`repro_torch.core.collectives`.  Vertices are
range-partitioned after a partitioner-driven relabel (partitioning.py).
The host layout (:class:`ShardedGraph`, :func:`push_layout`) is the
reference's, array for array; each rank takes its slice of it
(:func:`rank_shard`) onto its device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import collectives as C
from repro_torch.core import partitioning as part_mod
from repro_torch.core.abstraction import DeviceGraph, gather_scale_segment_sum
from repro_torch.core.sync import HaloCache, HysyncController, SyncPolicy
from repro_torch.graph.structure import Graph


@dataclasses.dataclass
class ShardedGraph:
    """Host-prepared, rank-sliceable graph layout (numpy).

    Arrays are concatenated per-rank segments (axis 0 splits over ranks):
      edge_src_g:  (n_dev * E_loc,) GLOBAL src id         (pull layout)
      edge_dst_l:  (n_dev * E_loc,) LOCAL dst id
      edge_mask:   (n_dev * E_loc,)
      x:           (N_pad, F) permuted features
      labels/mask: (N_pad,)
      in_deg:      (N_pad,) global in-degree (clamped >= 1)
      out_deg:     (N_pad,)
    """
    n_dev: int
    n_local: int
    e_local: int
    perm: np.ndarray
    edge_src_g: np.ndarray
    edge_dst_l: np.ndarray
    edge_mask: np.ndarray
    x: np.ndarray
    labels: np.ndarray
    label_mask: np.ndarray
    in_deg: np.ndarray
    out_deg: np.ndarray

    @property
    def n_pad(self) -> int:
        return self.n_local * self.n_dev


def shard_graph(g: Graph, n_dev: int, *, method: str = "hash",
                feat: Optional[np.ndarray] = None) -> ShardedGraph:
    """Partition with the chosen edge-cut strategy, relabel vertices to
    contiguous per-rank ranges, pad, and build the pull edge layout."""
    p = part_mod.partition(g, n_dev, method)
    if not isinstance(p, part_mod.EdgeCutPartition):
        raise ValueError("distributed full-graph training uses edge-cut "
                         "partitioners")
    order, counts = part_mod.contiguousize(g, p)  # order[new] = old
    n_local = int(np.ceil(counts.max() / 1)) if n_dev == 1 else int(
        np.ceil(g.num_nodes / n_dev))
    n_local = max(n_local, int(counts.max()))
    n_pad = n_local * n_dev

    # new id layout: rank d owns [d*n_local, d*n_local + counts[d])
    # (order is stable by partition: a vertex's place in its range is its
    # position in order less its partition's first position)
    new_of_old = np.full(g.num_nodes, -1, np.int64)
    assign = p.assignment[order].astype(np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    new_of_old[order] = (assign * n_local
                         + np.arange(len(order)) - first[assign])

    e = g.edges()
    src_new = new_of_old[e[:, 0]]
    dst_new = new_of_old[e[:, 1]]
    dst_dev = dst_new // n_local

    # group edges by destination owner, pad each rank to e_local
    e_local = 0
    groups = []
    for d in range(n_dev):
        sel = dst_dev == d
        groups.append((src_new[sel], dst_new[sel] - d * n_local))
        e_local = max(e_local, int(sel.sum()))
    e_local = max(e_local, 1)
    es, ed, em = _padded(groups, n_dev, e_local)

    feats = g.features if feat is None else feat
    x = np.zeros((n_pad, feats.shape[1]), np.float32)
    labels = np.zeros((n_pad,), np.int32)
    lmask = np.zeros((n_pad,), np.float32)
    x[new_of_old] = feats
    if g.labels is not None:
        labels[new_of_old] = g.labels
        lmask[new_of_old] = 1.0
    indeg = np.ones((n_pad,), np.float32)
    outdeg = np.ones((n_pad,), np.float32)
    indeg[new_of_old] = np.maximum(g.in_degree(), 1)
    outdeg[new_of_old] = np.maximum(g.out_degree(), 1)

    return ShardedGraph(
        n_dev=n_dev, n_local=n_local, e_local=e_local, perm=new_of_old,
        edge_src_g=es, edge_dst_l=ed, edge_mask=em, x=x, labels=labels,
        label_mask=lmask, in_deg=indeg, out_deg=outdeg)


def _padded(groups, n_dev: int, e_local: int):
    """Per-rank ``(src, dst)`` groups as flat int32 arrays padded to
    ``e_local`` slots a rank, with their validity mask."""
    es = np.zeros((n_dev, e_local), np.int32)
    ed = np.zeros((n_dev, e_local), np.int32)
    em = np.zeros((n_dev, e_local), bool)
    for d, (s_, d_) in enumerate(groups):
        k = len(s_)
        es[d, :k] = s_
        ed[d, :k] = d_
        em[d, :k] = True
    return es.reshape(-1), ed.reshape(-1), em.reshape(-1)


def push_layout(sg: ShardedGraph, g: Graph) -> dict:
    """Re-group the edge list by SOURCE owner (push layout)."""
    e = g.edges()
    src_new = sg.perm[e[:, 0]]
    dst_new = sg.perm[e[:, 1]]
    src_dev = src_new // sg.n_local
    groups = []
    e_local = 1
    for d in range(sg.n_dev):
        sel = src_dev == d
        groups.append((src_new[sel] - d * sg.n_local, dst_new[sel]))
        e_local = max(e_local, int(sel.sum()))
    es, ed, em = _padded(groups, sg.n_dev, e_local)
    return {"edge_src_l": es, "edge_dst_g": ed, "edge_mask": em}


# ---------------------------------------------------------------------------
# one rank's slice, on its device
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RankShard:
    """One rank's part of a :class:`ShardedGraph` on its device.

    ``graph`` holds the rank's edge slice with both grouped layouts: in
    the pull layout ``N_pad`` sources onto the ``n_local`` owned
    destinations, in the push layout the ``n_local`` owned sources onto
    all ``N_pad`` destinations.  ``coef`` is the per-edge GCN coefficient
    ``1/sqrt(d_out d_in)`` from the GLOBAL degrees (the ``DeviceGraph``'s
    own degrees count only this rank's edges and are not used);
    ``x``, ``labels`` and ``label_mask`` are the owned rows."""
    rank: int
    n_dev: int
    n_local: int
    push: bool
    graph: DeviceGraph
    coef: torch.Tensor
    x: torch.Tensor
    labels: torch.Tensor
    label_mask: torch.Tensor

    @property
    def n_pad(self) -> int:
        return self.n_local * self.n_dev


def rank_shard(sg: ShardedGraph, rank: int, device, *,
               push_arrays: Optional[dict] = None) -> RankShard:
    """Rank ``rank``'s slice of ``sg`` on ``device``: the pull layout, or
    with ``push_arrays`` (from :func:`push_layout`) the push layout."""
    device = torch.device(device)
    n_local, n_pad = sg.n_local, sg.n_pad
    own = slice(rank * n_local, (rank + 1) * n_local)
    if push_arrays is None:
        es_all, ed_all, em_all = (sg.edge_src_g, sg.edge_dst_l,
                                  sg.edge_mask)
        n_src, n_dst = n_pad, n_local
        deg_src, deg_dst = sg.out_deg, sg.in_deg[own]
    else:
        es_all, ed_all, em_all = (push_arrays["edge_src_l"],
                                  push_arrays["edge_dst_g"],
                                  push_arrays["edge_mask"])
        n_src, n_dst = n_local, n_pad
        deg_src, deg_dst = sg.out_deg[own], sg.in_deg
    e_local = len(es_all) // sg.n_dev
    sl = slice(rank * e_local, (rank + 1) * e_local)
    dg = DeviceGraph._build(es_all[sl], ed_all[sl], em_all[sl], n_src, n_dst,
                            device, src_layout=True)
    # the reference's rsqrt(take(out_deg, src)) * rsqrt(take(in_deg, dst))
    coef = (torch.rsqrt(torch.from_numpy(deg_src).to(device))[
        dg.edge_src.long()]
        * torch.rsqrt(torch.from_numpy(np.ascontiguousarray(deg_dst))
                      .to(device))[dg.edge_dst.long()])

    def rows(a):
        return torch.from_numpy(np.ascontiguousarray(a[own])).to(device)

    return RankShard(rank=rank, n_dev=sg.n_dev, n_local=n_local,
                     push=push_arrays is not None, graph=dg, coef=coef,
                     x=rows(sg.x), labels=rows(sg.labels),
                     label_mask=rows(sg.label_mask))


# ---------------------------------------------------------------------------
# pull / push aggregation primitives (one rank's part)
# ---------------------------------------------------------------------------

def aggregate(h: torch.Tensor, g: DeviceGraph, coef_e=None) -> torch.Tensor:
    """K1 over ``g``: the mask times ``coef_e`` as the coefficient, the
    transpose over the src layout in the backward."""
    coef = g.edge_mask.to(h.dtype)
    if coef_e is not None:
        coef = coef * coef_e
    return gather_scale_segment_sum(h, g.edge_src, g.edge_dst, coef,
                                    g.num_dst, layout=g.layout,
                                    src_layout=g.src_layout)


def pull_aggregate(h_loc: torch.Tensor, shard: RankShard, *,
                   coef_e=None) -> torch.Tensor:
    """All-gather features, local segment-sum onto owned destinations.

    ``h_loc`` ``(n_local, F)`` owned rows; ``shard`` in the pull layout;
    ``coef_e`` optional per-edge coefficient.  Returns ``(n_local, F)``
    aggregates; masked (pad) edges contribute zero, so pad rows never
    aggregate.  The backward reduce-scatters the gathered rows' cotangent
    to their owners."""
    # repro-lint: disable=RL001 -- forward-pass all-gather, exact transpose
    h_all = C.AllGather.apply(h_loc)                        # (N_pad, F)
    return aggregate(h_all, shard.graph, coef_e)


def push_aggregate(h_loc: torch.Tensor, shard: RankShard, *,
                   coef_e=None) -> torch.Tensor:
    """Local partial aggregates for ALL destinations, reduce-scatter.

    ``shard`` in the push layout.  Returns this rank's ``(n_local, F)``
    slice of the summed aggregate; masked edges contribute zero.  The
    backward all-gathers the cotangent (no second reduction)."""
    partial = aggregate(h_loc, shard.graph, coef_e)        # (N_pad, F)
    # repro-lint: disable=RL001 -- forward-pass reduce-scatter, exact transpose
    return C.ReduceScatter.apply(partial)                   # (N_loc, F)


# ---------------------------------------------------------------------------
# distributed GCN training step (pull | push | stale-pull)
# ---------------------------------------------------------------------------

def gcn_forward_local(params, h_loc: torch.Tensor, shard: RankShard, *,
                      mode: str, halo_cache: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Pull-layout GCN forward of one rank; GCN normalization
    1/sqrt(d_out d_in) per edge.  ``mode="stale"`` with a ``halo_cache``
    (the replicated ``(N_pad, F_in)`` input features) reads layer 0's
    sources from it instead of the all-gather, as DistGNN's delayed
    halo; deeper layers still synchronize."""
    h = h_loc
    n_layers = len(params)
    for i, layer in enumerate(params):
        if mode == "stale" and halo_cache is not None and i == 0:
            h = aggregate(halo_cache @ layer.w, shard.graph, shard.coef)
        else:
            h = pull_aggregate(h @ layer.w, shard, coef_e=shard.coef)
        h = h + layer.b
        if i + 1 < n_layers:
            h = F.relu(h)
    return h


def gcn_forward_push(params, h_loc: torch.Tensor, shard: RankShard
                     ) -> torch.Tensor:
    """Push-mode GCN forward (Pregel/NeuGraph): each rank computes its
    LOCAL sources' contributions for every destination and
    reduce-scatters partial aggregates."""
    h = h_loc
    n_layers = len(params)
    for i, layer in enumerate(params):
        h = push_aggregate(h @ layer.w, shard, coef_e=shard.coef) + layer.b
        if i + 1 < n_layers:
            h = F.relu(h)
    return h


def label_count(shard: RankShard) -> torch.Tensor:
    """The global number of labelled rows (at least 1): summed over the
    ranks OUTSIDE any differentiated function (the PR 2/PR 9 rule: a
    collective inside the loss would be differentiated too)."""
    return torch.clamp(C.all_reduce_sum(torch.sum(shard.label_mask)),
                       min=1.0)


def local_loss(h: torch.Tensor, shard: RankShard,
               cnt: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean NLL over every labelled row."""
    logz = torch.logsumexp(h, dim=-1)
    gold = torch.gather(h, -1, shard.labels.long()[:, None])[:, 0]
    return torch.sum((logz - gold) * shard.label_mask) / cnt


def sum_grads_and_loss(params, loss_local: torch.Tensor, *,
                       keep=()) -> torch.Tensor:
    """Sum every rank's gradients into each parameter's ``grad`` (a SUM:
    each rank's gradient covers only its own rows of the loss) and return
    the summed loss, in one all-reduce of one flat vector.  Parameters in
    ``keep`` keep their own gradient (P3's feature-sharded W1)."""
    ps = [p for p in params.parameters() if all(p is not k for k in keep)]
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in ps]
                     + [loss_local.detach().reshape(1)])
    tot = C.all_reduce_sum(flat)
    off = 0
    for p in ps:
        p.grad = tot[off:off + p.numel()].view_as(p)
        off += p.numel()
    return tot[-1]


def make_distributed_gcn_step(optimizer, *, mode: str = "pull"):
    """One rank's full-graph distributed GCN step.

    ``mode``: ``"pull"`` (all-gather features), ``"stale"`` (DistGNN
    delayed halos: pass ``halo_cache``) or ``"push"`` (reduce-scatter
    partial aggregates; the shard in the push layout).  Returns
    ``train_step(params, shard, halo_cache=None) -> loss``: the loss
    summed over the ranks (a 0-d tensor on the device), after the
    gradients were summed over the ranks and ``optimizer`` (built on
    ``params``, replicated on every rank) stepped — identically on every
    rank, which keeps the replicas equal.  The label count is summed
    before the forward, outside the differentiated function."""
    if mode not in ("pull", "push", "stale"):
        raise ValueError(f"unknown mode {mode!r}")

    def train_step(params, shard: RankShard, halo_cache=None):
        if shard.push != (mode == "push"):
            raise ValueError(f"mode {mode!r} needs the "
                             f"{'push' if mode == 'push' else 'pull'} "
                             f"layout")
        cnt = label_count(shard)
        optimizer.zero_grad(set_to_none=True)
        if mode == "push":
            h = gcn_forward_push(params, shard.x, shard)
        else:
            h = gcn_forward_local(params, shard.x, shard, mode=mode,
                                  halo_cache=halo_cache)
        loss = local_loss(h, shard, cnt)
        loss.backward()
        total = sum_grads_and_loss(params, loss)
        optimizer.step()
        return total

    return train_step


def _quiet(*_a, **_k) -> None:
    pass


def run_sync(model, optimizer, sg: ShardedGraph, g: Graph, rank: int,
             device, *, mode: str = "pull", steps: int, staleness: int = 4,
             log=_quiet) -> dict:
    """``steps`` synchronous steps of one rank over ``sg`` (reference
    ``launch/train_gnn.py:301-349``): ``mode`` ``pull``, ``push``,
    ``stale`` (DistGNN's layer-0 halo, the replicated input features
    refreshed every ``staleness`` steps) or ``hysync`` (stale until the
    loss stops falling, then synchronous).  ``g`` is the host graph
    ``sg`` was cut from (the push layout regroups its edges).  Returns
    the losses, one :class:`~repro_torch.core.collectives.StepClock` row
    a step (``epochs``), the seconds spent building the rank's shard
    (``setup_s``), the layout's sizes and the stale modes' reports."""
    if mode not in ("pull", "push", "stale", "hysync"):
        raise ValueError(f"unknown mode {mode!r}")
    device = torch.device(device)
    t0 = time.perf_counter()
    push = mode == "push"
    shard = rank_shard(sg, rank, device, push_arrays=(
        push_layout(sg, g) if push else None))
    stale_like = mode in ("stale", "hysync")
    # the replicated input features, DistGNN's layer-0 halo snapshot
    x_full = torch.from_numpy(sg.x).to(device) if stale_like else None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    step = make_distributed_gcn_step(
        optimizer, mode="push" if push else ("stale" if stale_like
                                             else "pull"))
    hysync = (HysyncController(stale_s=staleness) if mode == "hysync"
              else None)
    policy = SyncPolicy(mode="stale" if stale_like else "bsp",
                        staleness=staleness)
    halo = HaloCache(x_full)
    clock = C.StepClock(device)
    losses = []
    for i in range(steps):
        if hysync is not None:
            policy.staleness = hysync.staleness()
        cache_val = (halo.maybe_refresh(policy, i, x_full) if stale_like
                     else None)
        with clock.step():
            loss = float(step(model, shard, halo_cache=cache_val))
        losses.append(loss)
        if hysync is not None:
            hysync.observe(i, loss)
        if i % 5 == 0 or i == steps - 1:
            extra = f" mode={hysync.mode}" if hysync else ""
            log(f"epoch {i:3d} loss {loss:.4f}{extra}")
    out = {"mode": mode, "losses": losses, "epochs": clock.rows,
           "setup_s": setup_s, "n_local": sg.n_local, "n_pad": sg.n_pad,
           "edges": int(shard.graph.order.numel())}
    if mode == "stale":
        log(f"halo-exchange savings vs BSP: {halo.comm_savings():.0%}")
    if hysync is not None:
        out["hysync_switch_epoch"] = hysync.switch_step
        if hysync.switch_step is not None:
            log(f"hysync switched stale->bsp at epoch "
                f"{hysync.switch_step}; savings {halo.comm_savings():.0%}")
    if stale_like:
        out["halo_comm_savings"] = halo.comm_savings()
    return out
