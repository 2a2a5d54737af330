"""Sharding rules (a copy of the reference's ``launch/sharding.py``):
logical-axis tables mapping param / cache / batch tree paths to specs
(MaxText-style), plus a context-var driven :func:`constrain` used inside
the model (the identity when no rules are active or on a plain tensor).

A spec is a tuple with one entry a tensor dim, as the reference's
``PartitionSpec``: ``None`` (replicated), a mesh axis name, or a tuple
of axis names (the dim split over all of them, the first outermost).
:func:`placements` turns one into DTensor placements on a
``DeviceMesh``; :func:`distribute` makes a tree of DTensors by a tree of
specs.  The spec functions read only the mesh's axis sizes, so they also
take a plain ``{axis: size}`` mapping.

Mesh axes:
  single-pod:  ("data", "model")           = (16, 16)
  multi-pod:   ("pod", "data", "model")    = (2, 16, 16)

Policy (the reference's):
  * weights: "model" on the feature/expert/head output dim; for *training*
    an additional FSDP-style "data" shard on the other dim (ZeRO-ish; the
    optimizer moments inherit the same spec);
  * batch dims over ("pod", "data") when divisible, else replicated
    (long_500k has B=1);
  * KV/latent cache sequence dim over "model" (heads are often too few),
    and additionally over "data" when the batch can't be sharded.

The port keeps its layers as a list of per-layer dicts, so a param path
holds the layer's index (``layers/3/attn/wq``); :func:`param_specs`
drops it and gives the leaf the reference's spec of the stacked leaf
(``layers/attn/wq``) without its leading layer axis.
"""
from __future__ import annotations

import contextvars
import re
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None)


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (or of a mapping, as given)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class ShardingRules:
    """Holds the mesh + activation specs; installed via ``activate()``."""

    def __init__(self, mesh, *, batch_size: int):
        self.mesh = mesh
        sizes = axis_sizes(mesh)
        self.multi_pod = "pod" in sizes
        self.model_size = sizes["model"]
        batch_axes = ("pod", "data") if self.multi_pod else ("data",)
        n_batch_shards = int(np.prod([sizes[a] for a in batch_axes]))
        self.batch_axis = batch_axes if batch_size % n_batch_shards == 0 \
            else None
        # when the batch is unshardable (long_500k), spread caches over data
        self.seq_axes = ("data", "model") if self.batch_axis is None \
            else ("model",)

    # -- activation specs used by constrain --------------------------------
    def spec_for(self, kind: str, shape) -> Optional[tuple]:
        b = self.batch_axis
        if kind == "act":      # (B, S, D) or (B, 1, D)
            # Megatron-style sequence parallelism on the residual stream:
            # shards the per-layer saved activations over `model` too.
            if len(shape) == 3 and shape[1] % self.model_size == 0:
                return (b, "model", None)
            return (b, None, None)
        if kind == "logits":   # (B, S, V)
            return (b, None, "model")
        return None

    def activate(self):
        return _ActiveRules(self)


class _ActiveRules:
    def __init__(self, rules):
        self.rules = rules

    def __enter__(self):
        self.tok = _ACTIVE.set(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE.reset(self.tok)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def sharded(*xs) -> Optional[ShardingRules]:
    """The active rules when any of ``xs`` is a DTensor, else ``None``:
    the model's test for taking its sharded branch."""
    rules = _ACTIVE.get()
    if rules is None or not any(is_dtensor(x) for x in xs):
        return None
    return rules


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` redistributed to the active rules' spec for ``kind``; ``x``
    itself with no rules active, on a plain tensor, or for a kind the
    rules do not name."""
    rules = sharded(x)
    if rules is None:
        return x
    spec = rules.spec_for(kind, x.shape)
    if spec is None:
        return x
    return x.redistribute(rules.mesh, placements(spec, rules.mesh))


# ===========================================================================
# specs -> DTensor placements
# ===========================================================================

def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements on ``mesh`` of a spec: ``Shard(d)`` on each mesh
    axis that tensor dim ``d`` names, ``Replicate()`` on the others.  A dim
    split over several axes lists them outermost first, as the mesh
    orders them."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} named twice in {spec}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def shards(entry, sizes: Mapping) -> int:
    """How many ways a spec entry splits its dim."""
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    return int(np.prod([sizes[a] for a in axes]))


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a tensor of ``shape``."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        n = shards(entry, sizes)
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways ({spec})")
        out.append(dim // n)
    return tuple(out)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def distribute(tree, specs, mesh, *, requires_grad: bool = False):
    """A tree of DTensors on ``mesh``, each leaf of ``tree`` placed by its
    spec in ``specs`` (a tree of the same layout).  A leaf on the meta
    device becomes a zero shard of its local shape (under a
    ``FakeTensorMode``, a fake one: nothing is allocated); any other leaf
    is cut into this rank's shard of a copy of its values, with no
    communication (every rank holds the same tensor)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, spec):
        pl = placements(spec, mesh)
        if t.is_meta:
            shape = tuple(t.shape)
            local = torch.zeros(local_shape(shape, spec, mesh),
                                dtype=t.dtype)
            out = DTensor.from_local(local, mesh, pl, run_check=False,
                                     shape=torch.Size(shape),
                                     stride=_contiguous_stride(shape))
        else:
            # a copy: the shard must not alias the caller's tensor
            out = distribute_tensor(t.detach().clone(), mesh, pl,
                                    src_data_rank=None)
        return out.requires_grad_(True) if requires_grad else out

    return map_tree(one, tree, specs)


def map_tree(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves)`` over nested dicts and lists of
    tensors (specs, tuples, are leaves of the other trees)."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [map_tree(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts and lists, the path the keys
    and list indices joined by '/'."""
    if isinstance(tree, Mapping):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


# ===========================================================================
# parameter specs
# ===========================================================================

# (regex on '/'-joined path, spec builder).  `d` = "data" iff fsdp else None.
_PARAM_RULES = [
    # embeddings: (V, D) vocab over model
    (r"embedding$",            lambda d: ("model", d)),
    (r"lm_head$",              lambda d: (d, "model")),
    (r"(enc|dec)_pos$",        lambda d: (None, None)),
    # attention
    (r"attn/w[qkv]$",          lambda d: (d, "model")),
    (r"attn/wo$",              lambda d: ("model", d)),
    (r"attn/b[qkv]$",          lambda d: ("model",)),
    (r"xattn/w[qkv]$",         lambda d: (d, "model")),
    (r"xattn/wo$",             lambda d: ("model", d)),
    (r"xattn/b[qkv]$",         lambda d: ("model",)),
    # MLA
    (r"attn/wq_a$",            lambda d: (d, "model")),
    (r"attn/wq_b$",            lambda d: (d, "model")),
    (r"attn/wkv_a$",           lambda d: (d, None)),
    (r"attn/w_k_nope$",        lambda d: (d, "model", None)),
    (r"attn/w_v$",             lambda d: (d, "model", None)),
    # MLP
    (r"mlp/w_(in|gate)$",      lambda d: (d, "model")),
    (r"mlp/w_out$",            lambda d: ("model", d)),
    (r"shared/w_(in|gate)$",   lambda d: (d, "model")),
    (r"shared/w_out$",         lambda d: ("model", d)),
    # MoE: experts over model (expert parallel)
    (r"moe/router$",           lambda d: (None, None)),
    (r"moe/w_(in|gate)$",      lambda d: ("model", d, None)),
    (r"moe/w_out$",            lambda d: ("model", None, d)),
    # SSM
    (r"ssm/w_z$",              lambda d: (d, "model")),
    (r"ssm/w_xbc$",            lambda d: (d, "model")),
    (r"ssm/w_dt$",             lambda d: (d, "model")),
    (r"ssm/conv_w$",           lambda d: (None, "model")),
    (r"ssm/conv_b$",           lambda d: ("model",)),
    (r"ssm/(A_log|D|dt_bias)$", lambda d: ("model",)),
    (r"ssm/norm$",             lambda d: ("model",)),
    (r"ssm/out_proj$",         lambda d: ("model", d)),
]

#: the param keys holding a list of layers (the reference's stacks)
_STACKS = r"(enc_|dec_|dense_|moe_)?layers"


def rule_path(path: str) -> str:
    """A port param path as the reference names its leaf: the layer index
    after a stack's key dropped (``layers/3/attn/wq`` ->
    ``layers/attn/wq``)."""
    return re.sub(rf"(^|/)({_STACKS})/\d+(/|$)", r"\1\2\4", path)


def _spec_matches(spec, shape, mesh, stacked: bool) -> tuple:
    """Prepend the layer-stack axis, drop axes that don't divide."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec)
    if stacked:
        spec = (None,) + spec
    spec = spec + (None,) * (len(shape) - len(spec))
    return tuple(ax if ax is None or dim % shards(ax, sizes) == 0 else None
                 for dim, ax in zip(shape, spec))


def param_spec(path: str, shape, mesh, *, fsdp: bool) -> tuple:
    """The spec of one param leaf (the port's path, its shape)."""
    d = "data" if fsdp else None
    s = rule_path(path)
    for pat, builder in _PARAM_RULES:
        if re.search(pat, s):
            return _spec_matches(builder(d), shape, mesh, stacked=False)
    # norms, scalars, biases — replicate
    return (None,) * len(shape)


def param_specs(params, mesh, *, fsdp: bool):
    """Spec tree matching ``params`` (the port's nested dicts and lists)."""
    return map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh,
                                      fsdp=fsdp), params)


def cache_specs(cache, mesh, rules: ShardingRules):
    """KV/state cache specs.  Leaves are (L, B, C, ...) or (L, B, H, P, N)."""
    b = rules.batch_axis
    seq = rules.seq_axes

    def one(s, leaf):
        shape = tuple(leaf.shape)
        if re.search(r"(^|/)(k|v|c|kr)$", s):
            # (L, B, C, K, hd) or (L, B, C, dc)
            spec = [None, b, seq] + [None] * (len(shape) - 3)
        elif s.endswith("state"):
            spec = [None, b, "model"] + [None] * (len(shape) - 3)
        elif s.endswith("conv"):
            spec = [None, b, None, "model"]
        else:
            spec = [None] * len(shape)
        return _spec_matches(spec[1:], shape, mesh, stacked=True)

    return map_with_path(one, cache)


def batch_specs(batch, mesh, rules: ShardingRules):
    b = rules.batch_axis

    def one(s, leaf):
        shape = tuple(leaf.shape)
        if s.endswith("pos"):
            return ()
        if s.endswith("positions"):          # (3, B, S)
            return _spec_matches((None, b), shape, mesh, False)
        return _spec_matches((b,), shape, mesh, False)

    return map_with_path(one, batch)


def _placed(t, pl) -> torch.Tensor:
    """DTensor ``t`` redistributed to placements ``pl`` (``t`` itself
    where it has them)."""
    return t if tuple(pl) == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


def reduced(t: torch.Tensor) -> torch.Tensor:
    """``t`` with any partial sum (a reduction over a split dim, as a
    norm's over a ``model``-split feature dim) all-reduced, so that
    DTensor does not reduce-scatter it along another dim; the identity on
    a plain tensor."""
    if sharded(t) is None:
        return t
    from torch.distributed.tensor import Partial, Replicate
    pl = tuple(Replicate() if isinstance(q, Partial) else q
               for q in t.placements)
    return _placed(t, pl)


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, ...) with its sequence dim all-gathered (Megatron
    sequence parallelism's gather into a tensor-parallel region, which
    the reference's GSPMD inserts before a projection); the identity on a
    plain tensor or one whose dim 1 is not sharded."""
    if sharded(x) is None:
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if q == Shard(1) else q for q in x.placements)
    return _placed(x, pl)


def scatter_seq(x: torch.Tensor) -> torch.Tensor:
    """The output (B, S, D) of a tensor-parallel region (a partial sum
    over ``model``) reduce-scattered to the residual stream's spec
    (``spec_for("act")``: the sequence over ``model`` where it divides),
    as sequence parallelism leaves a region; its transpose all-gathers
    the gradient back.  The identity on a plain tensor."""
    return constrain(x, "act") if x.dim() == 3 else x


def shard_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dim split over ``model`` (a local slice where
    it was replicated there), as the row-parallel product that reads it
    takes it; its transpose all-gathers the gradient.  The identity on a
    plain tensor or one already so split."""
    rules = sharded(t)
    if rules is None or t.shape[-1] % rules.model_size:
        return t
    from torch.distributed.tensor import Replicate, Shard
    names = t.device_mesh.mesh_dim_names
    pl = tuple(Shard(t.dim() - 1) if names[i] == "model" and
               isinstance(q, Replicate) else q
               for i, q in enumerate(t.placements))
    return _placed(t, pl)


def whole_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` (..., n * width), about to be split into ``n`` heads: its
    last dim's ``model`` shard all-gathered unless ``n`` divides over
    ``model`` (a shard must hold whole heads); else ``t`` itself."""
    rules = sharded(t)
    if rules is None or n % rules.model_size == 0:
        return t
    from torch.distributed.tensor import Replicate, Shard
    last = Shard(t.dim() - 1)
    names = t.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if names[i] == "model" and q in (last, Shard(-1))
               else q for i, q in enumerate(t.placements))
    return _placed(t, pl)


def gather_params(p):
    """A layer's params as it computes with them: each DTensor leaf with
    its FSDP shards (the ``data``/``pod`` axes) all-gathered, its
    ``model`` shards kept; plain tensors as they are.  Autograd's
    transpose of the gather reduce-scatters the gradient back to the
    param's own placement (ZeRO)."""
    if _ACTIVE.get() is None:
        return p

    def one(t):
        if not is_dtensor(t):
            return t
        from torch.distributed.tensor import Replicate
        names = t.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if names[i] != "model" else q
                   for i, q in enumerate(t.placements))
        return _placed(t, pl)
    return map_tree(one, p)


# ===========================================================================
# caches split along their sequence
# ===========================================================================

def seq_offset(t) -> int:
    """The first cache slot of this rank's shard of DTensor ``t`` (B, C,
    ...), its dim 1 split over the mesh axes that shard it (outermost
    first)."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    r = 0
    for i, q in enumerate(t.placements):
        if isinstance(q, Shard) and q.dim == 1:
            r = r * mesh.size(i) + coord[i]
    return r * t.to_local().shape[1]


def row_placements(t) -> tuple:
    """The placements of one row (B, ...) of cache DTensor ``t``: its
    batch split kept, replicated elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate()
                 for q in t.placements)


def write_slot(cache: torch.Tensor, slot: int, row: torch.Tensor) -> None:
    """``cache[:, slot] = row`` in place.  On a DTensor cache split along
    its sequence, ``row`` is gathered to the cache's row placement and
    written by the rank that holds ``slot``, into its local shard."""
    if sharded(cache) is None:
        cache[:, slot] = row.to(cache.dtype)
        return
    row = row.redistribute(cache.device_mesh, row_placements(cache))
    local = cache.to_local()
    lo = seq_offset(cache)
    if lo <= slot < lo + local.shape[1]:
        local[:, slot - lo] = row.to_local().to(local.dtype)


def split_softmax(rules, scores, values, q_args, cache_args, q_specs):
    """The pieces of ``sum_s softmax(scores)_s * values_s`` over a cache
    split along its sequence (dim 1 of every ``cache_args`` DTensor), as
    a sharded softmax: each rank takes the max of its slots' scores
    (all-reduced, max), then its sum of ``exp(score - max)`` and of those
    weights times its values (both all-reduced, sum).  Returns ``(sum,
    weighted)``, both with the first cache's row placement; the caller
    divides.

    ``scores(*q_locals, *cache_locals, offset)`` gives the local scores,
    the slot on the last dim (masked slots at ``NEG_INF``; ``offset`` is
    the shard's first slot); ``values(w, *cache_locals)`` the weighted sum
    of the local values.  ``q_specs``: the specs (or placements) of the
    ``q_args``."""
    from torch.distributed.tensor import Partial, Shard
    mesh = rules.mesh
    first = cache_args[0]
    row = row_placements(first)
    specs = list(q_specs) + [tuple(c.placements) for c in cache_args]
    off = seq_offset(first)
    nq = len(q_args)

    def partial(op):
        # the row's placements, partial over the axes splitting the cache
        return tuple(Partial(op) if isinstance(q, Shard) and q.dim == 1
                     else r for q, r in zip(first.placements, row))

    m = on_shards(lambda *a: scores(*a, off).detach().amax(-1), specs,
                  partial("max"), rules)(*q_args, *cache_args)
    m = m.redistribute(mesh, row)

    def local(*a):
        w = torch.exp(scores(*a[:-1], off) - a[-1][..., None])
        return w.sum(-1), values(w, *a[nq:-1])

    se, acc = on_shards(local, specs + [row],
                        [partial("sum"), partial("sum")], rules)(
        *q_args, *cache_args, m)
    return se.redistribute(mesh, row), acc.redistribute(mesh, row)


# ===========================================================================
# regions DTensor has no rule for
# ===========================================================================

def on_shards(fn: Callable, in_specs: Sequence, out_specs,
              rules: Optional[ShardingRules] = None) -> Callable:
    """``fn`` run on each device's local shards (``local_map``): the
    DTensor arguments are first redistributed to ``in_specs`` (one spec,
    or ``None`` for a non-tensor, an argument), the outputs placed by
    ``out_specs`` (a spec, or a list of them for a tuple of outputs; a
    tuple of placements is taken as it is).  Plain tensors pass to ``fn``
    unchanged, so with no rules active this is ``fn``.

    The work is split along every mesh axis that splits an argument, so
    an argument replicated over such an axis (a weight beside a batch
    split over ``data``, a KV head group beside query heads split over
    ``model``) is used in part by each rank there: its gradient is a
    partial sum over that axis, summed in the backward."""
    rules = rules or _ACTIVE.get()
    if rules is None:
        return fn
    from torch.distributed.tensor import (Partial, Placement, Replicate,
                                          Shard)
    from torch.distributed.tensor.experimental import local_map
    mesh = rules.mesh

    def pl(spec):
        if spec is None:
            return None
        if spec and all(isinstance(p, Placement) for p in spec):
            return list(spec)
        return list(placements(spec, mesh))

    ins = tuple(pl(s) for s in in_specs)
    split = {d for p in ins if p is not None for d, q in enumerate(p)
             if isinstance(q, Shard)}
    grads = tuple(None if p is None else
                  [Partial() if d in split and isinstance(q, Replicate)
                   else q for d, q in enumerate(p)] for p in ins)
    outs = tuple(pl(s) for s in out_specs) if isinstance(out_specs, list) \
        else pl(out_specs)
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)
