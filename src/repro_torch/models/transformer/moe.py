"""Mixture-of-Experts block (PyTorch port of the reference's
``models/transformer/moe.py``).

:func:`moe_block` keeps the reference's GShard semantics: tokens are
flattened to T = B·S and grouped into chunks of ``group_size`` (so a
decode step, S == 1, groups over the batch), each expert takes at most
C = ceil(g·k/E · capacity_factor) tokens of a group, and a token whose
place in its expert's queue is C or later is dropped (GShard's dropping,
capacity factor 1.25).  A place is the exclusive cumsum over the group's
flattened (token, slot) order, the k slots of a token in descending-gate
order.

The reference computes dispatch and combine as one-hot einsums over a
(n, g, E, C) tensor.  That tensor holds 0/1 at unique (e, c) slots (and
the gate weight w there, for combine), so the port gathers instead: each
slot's token row into (E, n·C, D), and each (token, slot)'s expert
output back, weighted and summed over the k slots.  The values are the
einsums' up to the order of those k-term sums, and no (n, g, k, E, C)
tensor is built (17 GB at Granite's prefill with capacity factor 8).
This is :func:`moe_block_gathered`'s method applied per group.

The expert products are batched matrix products (the reference computes
them in XLA, outside any Pallas kernel).  Casts follow the reference:
the router runs in float32, the combine weights take the activations'
dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as shd
from repro_torch.models.transformer import layers as L


def init_moe(cfg, gen, dtype, device):
    """Random expert parameters with the reference's distributions: the
    router ``(D, E)`` in float32, ``w_gate`` and ``w_in`` ``(E, D, F)``,
    ``w_out`` ``(E, F, D)``, and a shared expert's MLP (``moe_d_ff ×
    num_shared_experts`` wide) where the config has one."""
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": L.normal(gen, (D, E), device, 0.02),
         "w_gate": L.normal(gen, (E, D, Fd), device, 1.0 / np.sqrt(D), dtype),
         "w_in": L.normal(gen, (E, D, Fd), device, 1.0 / np.sqrt(D), dtype),
         "w_out": L.normal(gen, (E, Fd, D), device, 1.0 / np.sqrt(Fd),
                           dtype)}
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp(cfg, gen, D,
                                 cfg.moe_d_ff * cfg.num_shared_experts,
                                 dtype, device)
    return p


def _capacity(group: int, k: int, E: int, factor: float) -> int:
    return max(1, int(np.ceil(group * k / E * factor)))


def route(cfg, p, x: torch.Tensor):
    """Router: (weights (..., k), indices (..., k), gates (..., E)).  The
    logits are float32 products of ``x`` in float32; the top k gates, in
    descending order, renormalised to sum to 1."""
    logits = x.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(gates, cfg.experts_per_token, dim=-1, sorted=True)
    w = w / w.sum(dim=-1, keepdim=True)
    return w, idx, gates


def expert_ffn(cfg, xe: torch.Tensor, w_gate, w_in, w_out) -> torch.Tensor:
    """The experts' gated MLPs on their slots: ``xe`` (E, M, D) through
    ``(E, D, F)`` / ``(E, F, D)`` weights -> (E, M, D), three batched
    matrix products."""
    h = torch.bmm(xe, w_in)
    hg = torch.bmm(xe, w_gate)
    return torch.bmm(L._act(cfg, hg) * h, w_out)


def dispatch(x: torch.Tensor, idx: torch.Tensor, C: int, E_loc: int,
             first_expert: int = 0):
    """Capacity-limited gather dispatch over groups: ``x`` (n, g, D)
    tokens, ``idx`` (n, g, k) their experts, ``C`` slots an expert in
    each group, experts ``first_expert`` .. ``first_expert + E_loc - 1``
    computed here.  Returns ``xe`` (E_loc, n·C, D), each slot's token row
    (zeros in a slot no token took; an expert's slots of all n groups in
    one operand), ``slot`` (n·g·k,) the slot of each (token, slot) pair,
    ``E_loc·n·C`` where it is dropped or routed to another expert, and
    ``keep`` (n, g·k).  A place is counted in its expert's queue alone."""
    n, g, D = x.shape
    k = idx.shape[-1]
    local = idx.reshape(n, g * k) - first_expert
    is_local = (local >= 0) & (local < E_loc)
    bucket = torch.where(is_local, local, torch.full_like(local, E_loc))
    onehot = F.one_hot(bucket, E_loc + 1)[..., :E_loc]       # (n, g*k, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos_of = (pos * onehot).sum(-1)                           # (n, g*k)
    keep = is_local & (pos_of < C)
    # slot (e, group, place) of each kept (token, slot), in expert-major
    # order; every dropped one goes to the extra slot ``drop``, cut below
    drop = E_loc * n * C
    grp = torch.arange(n, device=x.device)[:, None]
    slot = torch.where(keep, bucket * (n * C) + grp * C + pos_of,
                       torch.full_like(pos_of, drop)).reshape(-1)
    tok = (grp * g + torch.arange(g * k, device=x.device) // k).reshape(-1)
    # each slot's token row (n·g: the zero row)
    src = torch.full((drop + 1,), n * g, dtype=torch.long, device=x.device)
    src.scatter_(0, slot, tok)
    x_pad = torch.cat([x.reshape(n * g, D), x.new_zeros(1, D)])
    return x_pad[src[:drop]].reshape(E_loc, n * C, D), slot, keep


def combine(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """The experts' outputs ``ye`` (E_loc, n·C, D) back to their tokens:
    each (token, slot) pair's row (``slot`` from :func:`dispatch`, zero
    where dropped) times its gate weight (``w`` (n, g, k), cast to the
    outputs' dtype), summed over the k slots -> (n, g, D)."""
    n, g, k = w.shape
    D = ye.shape[-1]
    ye_pad = torch.cat([ye.reshape(-1, D), ye.new_zeros(1, D)])
    contrib = ye_pad[slot].reshape(n, g, k, D)
    wk = (w.reshape(n, g * k) * keep).to(contrib.dtype).reshape(n, g, k)
    return torch.einsum("ntk,ntkd->ntd", wk, contrib)


def dispatch_combine(cfg, x: torch.Tensor, w: torch.Tensor,
                     idx: torch.Tensor, C: int, w_gate, w_in, w_out, *,
                     first_expert: int = 0) -> torch.Tensor:
    """:func:`dispatch`, the experts (``E_loc = w_in.shape[0]`` of them
    from ``first_expert``; all by default), :func:`combine`: (n, g, D) in
    ``x``'s dtype, each token's kept slots' expert outputs times their
    gate weights, summed.  A (token, slot) routed to an expert not
    computed here contributes nothing."""
    xe, slot, keep = dispatch(x, idx, C, w_in.shape[0], first_expert)
    ye = expert_ffn(cfg, xe, w_gate, w_in, w_out)
    return combine(ye, slot, keep, w).to(x.dtype)


def _shared(cfg, p, x, y):
    if cfg.num_shared_experts:
        y = y + L.mlp(cfg, x, p["shared"])
    return y


def moe_block(cfg, p, x: torch.Tensor, *,
              capacity_factor: Optional[float] = None,
              group_size: int = 1024) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), GShard dispatch.  Tokens are flattened
    to T = B·S and grouped into g = min(T, ``group_size``); a T above
    ``group_size`` that is not a multiple of it raises ``ValueError``
    (the reference fails there in a reshape).  Under sharding rules the
    experts run on their ``model`` shards (:func:`experts_sharded`)."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    g = min(T, group_size)
    if T % g:
        raise ValueError(f"{T} tokens do not divide into groups of "
                         f"{group_size}")
    n = T // g
    C = _capacity(g, k, E, capacity_factor)
    rules = shd.sharded(x, p["w_in"])
    if rules is not None:
        y = experts_sharded(rules, cfg, p, x, group=g, capacity=C)
        return _shared(cfg, p, x, y)
    xg = x.reshape(n, g, D)
    w, idx, _ = route(cfg, p, xg)
    y = dispatch_combine(cfg, xg, w, idx, C, p["w_gate"], p["w_in"],
                         p["w_out"])
    return _shared(cfg, p, x, y.reshape(B, S, D))


def experts_sharded(rules, cfg, p, x, *, group: int,
                    capacity: int) -> torch.Tensor:
    """The routed experts of (B, S, D) ``x`` under sharding rules, as the
    reference's ``shard_map`` expert parallelism computes them
    (``core/parallel.py:180-214``): the expert weights split over
    ``model`` (``moe/w_*``: ``P("model", d, None)``, the FSDP shard
    gathered), tokens over the batch axis, each rank routing its tokens,
    dispatching to its E/m experts (:func:`dispatch_combine` from its
    first expert) and adding their weighted outputs; the partial sums are
    summed over ``model``.  Tokens form groups of ``group`` in order, C
    = ``capacity`` slots an expert a group; where a rank's tokens do not
    fill whole groups (a decode step's batch), the batch is gathered
    first, so every group is the one a single device forms."""
    from torch.distributed.tensor import Partial
    B, S, D = x.shape
    E, m = cfg.num_experts, rules.model_size
    b = rules.batch_axis
    if b is not None and (B // shd.shards(b, shd.axis_sizes(rules.mesh))
                          * S) % group:
        b = None
    spec_x = (b, None, None)
    e_ax = "model" if E % m == 0 else None

    def local(x_l, router, w_gate, w_in, w_out):
        Bl = x_l.shape[0]
        first = rules.mesh.get_local_rank("model") * w_in.shape[0] \
            if e_ax else 0
        xg = x_l.reshape(Bl * S // group, group, D)
        w, idx, _ = route(cfg, {"router": router}, xg)
        y = dispatch_combine(cfg, xg, w, idx, capacity, w_gate, w_in,
                             w_out, first_expert=first)
        return y.reshape(Bl, S, D)

    names = rules.mesh.mesh_dim_names
    out = tuple(Partial() if a == "model" and e_ax else q for a, q in
                zip(names, shd.placements(spec_x, rules.mesh)))
    w_spec = (e_ax, None, None)
    return shd.on_shards(local, [spec_x, (None, None), w_spec, w_spec,
                                 w_spec], out, rules)(
        x, p["router"], p["w_gate"], p["w_in"], p["w_out"])


def moe_block_gathered(cfg, p, x: torch.Tensor, *,
                       capacity_factor: Optional[float] = None
                       ) -> torch.Tensor:
    """The reference's single-device gather dispatch: one group of all T
    tokens (C over T), the same drop semantics otherwise."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = _capacity(T, k, E, capacity_factor)
    xf = x.reshape(1, T, D)
    w, idx, _ = route(cfg, p, xf)
    y = dispatch_combine(cfg, xf, w, idx, C, p["w_gate"], p["w_in"],
                         p["w_out"])
    return _shared(cfg, p, x, y.reshape(B, S, D))
