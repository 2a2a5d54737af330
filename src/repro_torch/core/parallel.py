"""Parallelism strategies (survey §3.2.5 / §2.3.1, Tables 2 & 7).

GNN side:

* :func:`p3_layer1` + :func:`make_p3_train_step` — P³'s push-pull hybrid
  [Gandhi & Iyer, OSDI'21]: layer 1 runs *model-parallel over the feature
  dimension* (features never cross the network; only the (N, hidden)
  partial activations are reduce-scattered), deeper layers run
  data-parallel pull.  The survey singles this out (§3.2.5, §4.2).

One process a rank over :mod:`repro_torch.core.collectives`, as the
distributed full-graph modes of :mod:`repro_torch.core.propagation`: rank
``r`` holds columns ``[r·F/n, (r+1)·F/n)`` of every vertex's features and
the matching rows of W1 (:func:`p3_params`), the other parameters
replicated.  Every aggregation is K1 over the whole graph
(:func:`~repro_torch.core.propagation.aggregate`).

Transformer side:

* :func:`moe_expert_parallel` — expert parallelism over the world's
  ranks (the reference's ``shard_map`` over its ``model`` axis): rank
  ``r`` holds experts ``[r·E/n, (r+1)·E/n)`` (:func:`expert_shard`), the
  activations are replicated, each rank computes only its experts on the
  tokens routed to them (gather dispatch), and one sum over the ranks
  (:func:`repro_torch.core.collectives.all_reduce_sum`, in rank order)
  combines.  The reference's data axis (tokens sharded over the batch)
  is not ported: the port's world is the model axis alone.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import collectives as C
from repro_torch.core import propagation as PR
from repro_torch.core.abstraction import DeviceGraph
from repro_torch.graph.structure import Graph
from repro_torch.models.transformer import layers as TL
from repro_torch.models.transformer import moe as MOE


def feature_slice(feat_dim: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s columns of ``feat_dim`` features; raises
    ``ValueError`` unless ``world`` divides ``feat_dim`` (the reference's
    ``shard_map`` cannot split such a dimension either)."""
    if feat_dim % world:
        raise ValueError(f"P3 splits the {feat_dim} features over {world} "
                         f"ranks: {feat_dim} % {world} != 0")
    k = feat_dim // world
    return slice(rank * k, (rank + 1) * k)


@dataclasses.dataclass
class P3Shard:
    """One rank's inputs of the P3 step on its device: the whole graph
    (``N_pad`` sources onto ``N_pad`` destinations, in the
    :class:`~repro_torch.core.propagation.ShardedGraph`'s relabelled ids,
    both grouped layouts) with GCN's per-edge ``coef`` from the global
    degrees, the rank's feature columns ``x_f`` ``(N_pad, F/n)`` of every
    vertex, the labels of its ``n_local`` owned rows and the global label
    count (known on every rank's host)."""
    rank: int
    n_dev: int
    n_local: int
    graph: DeviceGraph
    coef: torch.Tensor
    x_f: torch.Tensor
    labels: torch.Tensor
    label_mask: torch.Tensor
    count: float


def p3_shard(sg: PR.ShardedGraph, g: Graph, rank: int,
             device: Union[str, torch.device]) -> P3Shard:
    """Rank ``rank``'s :class:`P3Shard` of ``sg`` (cut from ``g``) on
    ``device``."""
    device = torch.device(device)
    cols = feature_slice(sg.x.shape[1], rank, sg.n_dev)
    e = g.edges()
    es, ed = sg.perm[e[:, 0]], sg.perm[e[:, 1]]
    dg = DeviceGraph._build(es, ed, np.ones(len(es), bool), sg.n_pad,
                            sg.n_pad, device, src_layout=True)
    coef = (torch.rsqrt(torch.from_numpy(sg.out_deg).to(device))[
        dg.edge_src.long()]
        * torch.rsqrt(torch.from_numpy(sg.in_deg).to(device))[
            dg.edge_dst.long()])
    own = slice(rank * sg.n_local, (rank + 1) * sg.n_local)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return P3Shard(rank=rank, n_dev=sg.n_dev, n_local=sg.n_local, graph=dg,
                   coef=coef, x_f=dev(sg.x[:, cols]), labels=dev(
                       sg.labels[own]), label_mask=dev(sg.label_mask[own]),
                   count=float(sg.label_mask.sum()))


def p3_params(cfg, params_np: Sequence[dict], rank: int, world: int, *,
              device: Union[str, torch.device] = "cuda") -> nn.ModuleList:
    """The GCN ``params_np`` (the reference's full parameters as numpy) as
    rank ``rank`` holds them under P3: W1's rows of the rank's feature
    columns, everything else whole.  The ranks' W1 slices, concatenated
    in rank order, are the full W1."""
    from repro_torch.models.gnn import model as GM
    rows = feature_slice(cfg.feat_dim, rank, world)
    local = [dict(params_np[0], w=np.asarray(params_np[0]["w"])[rows])]
    local += [dict(p) for p in params_np[1:]]
    return GM.params_from_numpy(
        dataclasses.replace(cfg, feat_dim=rows.stop - rows.start), local,
        device=device)


def p3_layer1(x_f: torch.Tensor, w1_f: torch.Tensor,
              shard: P3Shard) -> torch.Tensor:
    """Layer 1's aggregation and projection on one rank: K1 over the
    whole graph at the rank's ``F/n`` columns (every vertex is present,
    so nothing crosses the network), times ``w1_f`` ``(F/n, H)``; the
    ``(N_pad, H)`` partials are reduce-scattered onto the vertex owners:
    ``(n_local, H)``.  The backward all-gathers the cotangent, so W1's
    slice gets its complete gradient (see :func:`make_p3_train_step`)."""
    agg = PR.aggregate(x_f, shard.graph, shard.coef)       # (N_pad, F/n)
    # repro-lint: disable=RL001 -- forward-pass reduce-scatter, exact transpose
    return C.ReduceScatter.apply(agg @ w1_f)              # (N_loc, H)


def p3_forward(params: nn.ModuleList, shard: P3Shard) -> torch.Tensor:
    """GCN logits of the rank's owned rows: layer 1 model-parallel
    (:func:`p3_layer1`), deeper layers data-parallel pull (all-gather of
    ``h @ W``, K1 over the whole graph, the owned rows kept)."""
    own = slice(shard.rank * shard.n_local,
                (shard.rank + 1) * shard.n_local)
    h = p3_layer1(shard.x_f, params[0].w, shard) + params[0].b
    h = F.relu(h)
    for i in range(1, len(params)):
        # repro-lint: disable=RL001 -- forward-pass all-gather, exact transpose
        h_all = C.AllGather.apply(h @ params[i].w)
        h = PR.aggregate(h_all, shard.graph, shard.coef)[own] + params[i].b
        if i + 1 < len(params):
            h = F.relu(h)
    return h


def clip_to_global_norm(params: nn.ModuleList, clip_norm: float) -> None:
    """Scale every gradient by ``min(1, clip_norm / (||g|| + 1e-9))``
    with ``||g||`` the norm of the WHOLE model's gradient: W1's slices of
    every rank (their squared norms summed over the ranks) and the
    summed replicated gradients, the same number on every rank."""
    w1 = params[0].w.grad
    sq = C.all_reduce_sum(torch.sum(w1 * w1).reshape(1))[0]
    for p in params.parameters():
        if p is not params[0].w and p.grad is not None:
            sq = sq + torch.sum(p.grad * p.grad)
    scale = torch.clamp(clip_norm / (torch.sqrt(sq) + 1e-9), max=1.0)
    for p in params.parameters():
        if p.grad is not None:
            p.grad.mul_(scale)


def make_p3_train_step(optimizer):
    """Distributed GCN with P3 hybrid parallelism, one rank's step.

    ``train_step(params, shard) -> loss``: ``params`` from
    :func:`p3_params` (the model ``optimizer`` was built on), ``shard``
    from :func:`p3_shard`.  The label count is the host's, outside the
    differentiated function.  Replicated parameters' gradients are each
    rank's local contribution and are SUMMED over the ranks; the
    feature-sharded W1's gradient is already complete for its own slice
    (the reduce-scatter's transpose delivers the full cotangent), so it
    is kept as it is (reference ``core/parallel.py:102-107``).  Returns
    the loss summed over the ranks (a 0-d tensor).

    An optimizer that clips to a global norm (``clip_norm`` in its
    defaults: :class:`~repro_torch.optim.AdamW`) would clip by the norm
    of the rank's own W1 slice; the step clips first by the whole
    model's norm (:func:`clip_to_global_norm`), after which the
    optimizer's own clip multiplies by 1.  The reference clips inside
    ``shard_map`` by each device's slice, so its replicated parameters
    drift apart between devices (ROADMAP.md, Queue 3)."""
    clip_norm = optimizer.defaults.get("clip_norm")

    def train_step(params: nn.ModuleList, shard: P3Shard) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        h = p3_forward(params, shard)
        loss = PR.local_loss(h, shard, max(shard.count, 1.0))
        loss.backward()
        total = PR.sum_grads_and_loss(params, loss, keep=(params[0].w,))
        if clip_norm:
            clip_to_global_norm(params, clip_norm)
        optimizer.step()
        return total

    return train_step


# ===========================================================================
# expert parallelism (transformer MoE)
# ===========================================================================

_EXPERT_KEYS = ("w_gate", "w_in", "w_out")


def expert_slice(num_experts: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s experts of ``num_experts``; raises ``ValueError``
    unless ``world`` divides ``num_experts`` (the reference's ``P("model",
    ...)`` cannot split them either)."""
    if num_experts % world:
        raise ValueError(f"expert parallelism splits {num_experts} experts "
                         f"over {world} ranks: {num_experts} % {world} != 0")
    k = num_experts // world
    return slice(rank * k, (rank + 1) * k)


def expert_shard(cfg, p: dict, rank: int, world: int) -> dict:
    """One MoE layer's params ``p`` as rank ``rank`` holds them under
    expert parallelism: its experts' rows of ``w_gate``, ``w_in`` and
    ``w_out`` (copies, so the full weights can be freed), the router and
    any shared expert whole."""
    sl = expert_slice(cfg.num_experts, rank, world)
    return {k: (v[sl].clone() if k in _EXPERT_KEYS else v)
            for k, v in p.items()}


def _local_expert_compute(cfg, x: torch.Tensor, router, w_gate, w_in, w_out,
                          capacity_factor: float, first_expert: int
                          ) -> torch.Tensor:
    """One rank's partial output: ``x`` (T, D) replicated, the expert
    weights the rank's ``E_loc`` experts from ``first_expert`` on.  The
    capacity C is taken over all T tokens, and places are counted in the
    local experts' queues (a queue belongs to one expert, so they are its
    places in the whole world).  Only the local experts' contributions
    are summed here; the caller sums over the ranks."""
    E, k, T = cfg.num_experts, cfg.experts_per_token, x.shape[0]
    C = MOE._capacity(T, k, E, capacity_factor)
    w, idx, _ = MOE.route(cfg, {"router": router}, x)
    y = MOE.dispatch_combine(cfg, x[None], w[None], idx[None], C, w_gate,
                             w_in, w_out, first_expert=first_expert)
    return y[0]


def moe_expert_parallel(cfg, p: dict, x: torch.Tensor, *,
                        capacity_factor: float = 1.25) -> torch.Tensor:
    """The MoE block under expert parallelism: ``x`` (B, S, D), the same
    on every rank, -> (B, S, D), the same bits on every rank.

    In a world of n ranks (``torch.distributed`` initialised, as
    :func:`repro_torch.core.collectives.init_world` does) rank r computes
    its experts ``[r·E/n, (r+1)·E/n)``; ``p``'s expert weights are either
    all E experts (the rank takes its rows) or the rank's E/n
    (:func:`expert_shard`).  The partial outputs are summed over the
    ranks in rank order.  Without a world it computes
    ``moe_block_gathered``, as the reference falls back without sharding
    rules (``core/parallel.py:186-190``).

    Under sharding rules (``launch/sharding.py``, ``x`` a DTensor) the
    group is the rules' ``model`` axis, not the whole world, as the
    reference's ``shard_map`` takes it: each rank routes its batch
    shard's tokens as one group (C over them) to its E/m experts, and the
    partial outputs are summed over ``model``
    (:func:`~repro_torch.models.transformer.moe.experts_sharded`)."""
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    rules = shd.sharded(x)
    if rules is not None:
        B, S, D = x.shape
        sizes = shd.axis_sizes(rules.mesh)
        b = rules.batch_axis
        T_loc = B * S // shd.shards(b, sizes)
        y = MOE.experts_sharded(
            rules, cfg, p, x, group=T_loc,
            capacity=MOE._capacity(T_loc, cfg.experts_per_token,
                                   cfg.num_experts, capacity_factor))
        if cfg.num_shared_experts:
            y = y + TL.mlp(cfg, x, p["shared"])
        return y
    if not dist.is_initialized():
        return MOE.moe_block_gathered(cfg, p, x,
                                      capacity_factor=capacity_factor)
    rank, world = C.rank(), C.world_size()
    sl = expert_slice(cfg.num_experts, rank, world)
    held = p["w_in"].shape[0]
    if held == cfg.num_experts:
        w = [p[k][sl] for k in _EXPERT_KEYS]
    elif held == sl.stop - sl.start:
        w = [p[k] for k in _EXPERT_KEYS]
    else:
        raise ValueError(f"rank {rank} of {world} holds {held} experts: "
                         f"neither all {cfg.num_experts} nor its "
                         f"{sl.stop - sl.start}")
    B, S, D = x.shape
    y = _local_expert_compute(cfg, x.reshape(B * S, D), p["router"], *w,
                              capacity_factor, sl.start)
    y = C.all_reduce_sum(y).reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + TL.mlp(cfg, x, p["shared"])
    return y
