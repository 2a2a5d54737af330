"""The transformer zoo's serving path, ``dense``, ``ssm``, ``hybrid``,
``moe`` and ``mla_moe`` families (PyTorch port of the reference's
``models/transformer/model.py``): init, forward, prefill (forward +
cache) and one-token decode.

Params are nested dicts with the reference's keys; ``params["layers"]``
is a list of per-layer dicts (the reference stacks a leading layer axis
and scans it; the port loops).  The ``hybrid`` family (Zamba2) runs
``num_layers / attn_every`` groups of ``attn_every`` SSM layers, each
followed by one dense block whose weights all groups share
(``params["shared_attn"]``, unstacked).  Caches keep the reference's
stacked layout, ``(num_layers, B, C, K, hd)`` for keys and values and
``(num_layers, B, H, P, N)`` / ``(num_layers, B, kw-1, Cd)`` for the SSM
(the hybrid's ``{"ssm": {...}, "attn": {"k", "v"}}`` holds one K/V slot
per group), and :func:`decode_step` writes them in place (the reference
donates them).  The ``moe`` family (Granite) is the dense block with the
MLP replaced by the experts (:func:`_moe`: GShard dispatch, or expert
parallelism with ``moe_impl="ep"``), with the dense family's K/V cache.
The ``mla_moe`` family (DeepSeek-V3) runs MLA blocks
(:func:`~repro_torch.models.transformer.attention.mla_forward`, its
prefill through K7 at q/k 192 and v 128 on the card; the absorbed
``mla_decode``), the first ``first_dense_layers`` with the dense MLP
(``params["dense_layers"]``), the rest with the experts
(``params["moe_layers"]``); its cache is the latent one, ``{"dense":
{"c", "kr"}, "moe": {"c", "kr"}}``, ``(n_layers, B, C, kv_lora_rank)``
and ``(n_layers, B, C, qk_rope_head_dim)``.

Batch conventions:
  forward / prefill:  {"tokens": (B, S) int}
  decode:             {"token": (B, 1) int, "pos": int}

The other families (``encdec``, ``vlm``) raise ``NotImplementedError``
naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import PORTED_FAMILIES, not_ported
from repro_torch.models.transformer import attention as A
from repro_torch.models.transformer import layers as L
from repro_torch.models.transformer import moe as MOE
from repro_torch.models.transformer import ssm as S


def _require_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        if cfg.family in ("encdec", "vlm"):
            raise not_ported(f"the {cfg.family!r} family ({cfg.name})",
                             cfg.family, NotImplementedError)
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family == "hybrid":
        _hybrid_groups(cfg)
    if cfg.family == "mla_moe" and not \
            0 <= cfg.first_dense_layers <= cfg.num_layers:
        raise ValueError(f"first_dense_layers {cfg.first_dense_layers} "
                         f"outside 0..num_layers {cfg.num_layers}")


def _hybrid_groups(cfg) -> int:
    """The hybrid family's groups of ``attn_every`` SSM layers; raises
    ``ValueError`` where ``attn_every`` does not divide ``num_layers``
    (the reference fails there in a reshape)."""
    per = cfg.attn_every
    if per <= 0 or cfg.num_layers % per:
        raise ValueError(f"attn_every {per} does not divide num_layers "
                         f"{cfg.num_layers} into groups")
    return cfg.num_layers // per


# ===========================================================================
# init
# ===========================================================================

def _init_dense_layer(cfg, gen, dtype, device):
    return {"attn": A.init_gqa(cfg, gen, dtype, device),
            "mlp": L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype, device),
            "ln1": L.init_norm(cfg, cfg.d_model, device),
            "ln2": L.init_norm(cfg, cfg.d_model, device)}


def _init_moe_layer(cfg, gen, dtype, device):
    return {"attn": A.init_gqa(cfg, gen, dtype, device),
            "moe": MOE.init_moe(cfg, gen, dtype, device),
            "ln1": L.init_norm(cfg, cfg.d_model, device),
            "ln2": L.init_norm(cfg, cfg.d_model, device)}


def _init_mla_dense_layer(cfg, gen, dtype, device):
    return {"attn": A.init_mla(cfg, gen, dtype, device),
            "mlp": L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype, device),
            "ln1": L.init_norm(cfg, cfg.d_model, device),
            "ln2": L.init_norm(cfg, cfg.d_model, device)}


def _init_mla_moe_layer(cfg, gen, dtype, device):
    return {"attn": A.init_mla(cfg, gen, dtype, device),
            "moe": MOE.init_moe(cfg, gen, dtype, device),
            "ln1": L.init_norm(cfg, cfg.d_model, device),
            "ln2": L.init_norm(cfg, cfg.d_model, device)}


def _init_ssm_layer(cfg, gen, dtype, device):
    return {"ssm": S.init_ssm(cfg, gen, dtype, device),
            "ln": L.init_norm(cfg, cfg.d_model, device)}


def init_params(cfg, gen: torch.Generator, *,
                device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Random params with the reference's distributions, drawn from
    ``gen`` (a generator on ``device``)."""
    _require_family(cfg)
    device = torch.device(device)
    dtype = L.dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {"embed": L.init_embed(cfg, gen, dtype, device),
                              "ln_f": L.init_norm(cfg, cfg.d_model, device)}
    if cfg.family == "mla_moe":
        nd = cfg.first_dense_layers
        params["dense_layers"] = [_init_mla_dense_layer(cfg, gen, dtype,
                                                        device)
                                  for _ in range(nd)]
        params["moe_layers"] = [_init_mla_moe_layer(cfg, gen, dtype, device)
                                for _ in range(cfg.num_layers - nd)]
        return params
    layer = {"dense": _init_dense_layer, "moe": _init_moe_layer}.get(
        cfg.family, _init_ssm_layer)
    params["layers"] = [layer(cfg, gen, dtype, device)
                        for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_dense_layer(cfg, gen, dtype, device)
    return params


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


#: the param keys that hold a list of layers (a stacked leading axis in
#: the reference)
STACKS = frozenset({"layers", "dense_layers", "moe_layers"})


def _map(fn, want, given):
    """``fn(want_leaf, given_leaf)`` over two param trees of one layout."""
    if isinstance(want, torch.Tensor):
        return fn(want, given)
    if isinstance(want, Mapping):
        return {k: _map(fn, want[k], given[k]) for k in want}
    return [_map(fn, w, g) for w, g in zip(want, given)]


def cast_params(cfg, params) -> Dict[str, Any]:
    """``params`` (of another dtype config of the same architecture) with
    each leaf in the dtype ``init_params(cfg)`` gives it: weights in
    ``cfg.param_dtype``, norms and SSM scalars in float32."""
    skeleton = init_params(cfg, torch.Generator(), device="meta")
    return _map(lambda w, g: g.to(w.dtype), skeleton, params)


def params_from_numpy(cfg, tree: Mapping, device: Union[str, torch.device]
                      = "cuda") -> Dict[str, Any]:
    """The port's params holding the reference's: ``tree`` is the
    reference's ``init_params`` pytree mapped to numpy, with stacked
    ``(n_layers, ...)`` leaves under ``layers`` (or, in ``mla_moe``,
    ``dense_layers`` and ``moe_layers``; the hybrid's ``shared_attn`` is
    one unstacked layer).  Keys and shapes must match the port's own;
    each leaf takes the port's dtype for it."""
    skeleton = init_params(cfg, torch.Generator(), device="meta")
    device = torch.device(device)

    def convert(want, given, path):
        if isinstance(want, torch.Tensor):
            arr = np.asarray(given)
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(f"{path}: shape {arr.shape} != "
                                 f"{tuple(want.shape)}")
            return torch.from_numpy(np.array(arr, np.float32)).to(
                device=device, dtype=want.dtype)
        if set(want) != set(given):
            raise ValueError(f"{path}: keys {sorted(given)} != "
                             f"{sorted(want)}")
        return {k: convert(want[k], given[k], f"{path}/{k}") for k in want}

    if set(tree) != set(skeleton):
        raise ValueError(f"top-level keys {sorted(tree)} != "
                         f"{sorted(skeleton)}")
    out = {k: convert(skeleton[k], tree[k], k)
           for k in skeleton if k not in STACKS}
    for name in STACKS.intersection(skeleton):
        out[name] = [convert(want, _index(tree[name], i), f"{name}[{i}]")
                     for i, want in enumerate(skeleton[name])]
    return out


def _index(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    arr = np.asarray(tree)
    return arr[i]


# ===========================================================================
# layer bodies
# ===========================================================================

def _moe(cfg, p, x):
    """The experts of one ``moe`` layer: GShard dispatch
    (:func:`~repro_torch.models.transformer.moe.moe_block`), or with
    ``cfg.moe_impl == "ep"`` expert parallelism over the ranks of a
    world (:func:`repro_torch.core.parallel.moe_expert_parallel`, which
    without a world computes the gathered single-device block, as the
    reference's does without sharding rules)."""
    if cfg.moe_impl == "ep":
        from repro_torch.core.parallel import moe_expert_parallel
        return moe_expert_parallel(cfg, p, x,
                                   capacity_factor=cfg.moe_capacity_factor)
    return MOE.moe_block(cfg, p, x)


def _ffn(cfg, p, h):
    """The feed-forward half of an attention block: the experts in a
    layer that has them (``moe``, ``mla_moe``'s MoE layers), the MLP in
    any other."""
    if "moe" in p:
        return _moe(cfg, p["moe"], h)
    return L.mlp(cfg, h, p["mlp"])


def _dense_body(cfg, x, p, positions):
    h = L.apply_norm(cfg, x, p["ln1"])
    x = x + A.gqa_forward(cfg, p["attn"], h, positions)
    h = L.apply_norm(cfg, x, p["ln2"])
    return x + _ffn(cfg, p, h)


def _ssm_body(cfg, x, p):
    h = L.apply_norm(cfg, x, p["ln"])
    return x + S.ssm_forward(cfg, p["ssm"], h)


def _mla_body(cfg, x, p, positions):
    h = L.apply_norm(cfg, x, p["ln1"])
    x = x + A.mla_forward(cfg, p["attn"], h, positions)
    h = L.apply_norm(cfg, x, p["ln2"])
    return x + _ffn(cfg, p, h)


def _mla_layers(params):
    """``mla_moe``'s layers in order, each with its cache stack's name and
    its index there: the dense ones, then the MoE ones."""
    for stack in ("dense", "moe"):
        for i, p in enumerate(params[f"{stack}_layers"]):
            yield stack, i, p


def _to_ring(dst, src):
    """The prompt's rows ``src`` (B, S, ...) into one layer's cache ``dst``
    (B, C, ...): position p in ring slot p % C, the last C positions kept
    (C == S without a window)."""
    Ssz, C = src.shape[1], dst.shape[1]
    kept = torch.arange(max(0, Ssz - C), Ssz, device=src.device)
    dst[:, kept % C] = src[:, kept].to(dst.dtype)


def _dense_prefill(cfg, x, p, positions, cache, i):
    """One dense block over the prompt, its keys and values into slot
    ``i`` of ``cache`` ({"k", "v"}; :func:`_to_ring`)."""
    hh = L.apply_norm(cfg, x, p["ln1"])
    o, (k, v) = A.gqa_forward(cfg, p["attn"], hh, positions,
                              window=cfg.sliding_window, return_kv=True)
    x = x + o
    hh = L.apply_norm(cfg, x, p["ln2"])
    x = x + _ffn(cfg, p, hh)
    _to_ring(cache["k"][i], k)
    _to_ring(cache["v"][i], v)
    return x


def _mla_prefill(cfg, x, p, positions, cache, i):
    """One MLA block over the prompt, its normalized latent and rotary key
    into slot ``i`` of ``cache`` ({"c", "kr"}; :func:`_to_ring`)."""
    hh = L.apply_norm(cfg, x, p["ln1"])
    o, (c_n, kr) = A.mla_forward(cfg, p["attn"], hh, positions,
                                 window=cfg.sliding_window,
                                 return_cache=True)
    x = x + o
    hh = L.apply_norm(cfg, x, p["ln2"])
    x = x + _ffn(cfg, p, hh)
    _to_ring(cache["c"][i], c_n)
    _to_ring(cache["kr"][i], kr)
    return x


def _positions(tokens):
    B, Ssz = tokens.shape
    return torch.arange(Ssz, device=tokens.device)[None].expand(B, Ssz)


# ===========================================================================
# forward (scoring path; no cache)
# ===========================================================================

def forward(cfg, params, batch) -> torch.Tensor:
    """Logits (B, S, padded_vocab) of ``batch["tokens"]``.  Attention is
    causal over the whole sequence (as the reference's ``forward`` with
    its default ``window=0``, sliding-window configs included)."""
    _require_family(cfg)
    x = L.embed(cfg, params["embed"], batch["tokens"])
    positions = _positions(batch["tokens"])
    if cfg.family in ("dense", "moe"):
        for p in params["layers"]:
            x = _dense_body(cfg, x, p, positions)
    elif cfg.family == "mla_moe":
        for _, _, p in _mla_layers(params):
            x = _mla_body(cfg, x, p, positions)
    else:
        for i, p in enumerate(params["layers"]):
            x = _ssm_body(cfg, x, p)
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x = _dense_body(cfg, x, params["shared_attn"], positions)
    x = L.apply_norm(cfg, x, params["ln_f"])
    return L.unembed(cfg, params["embed"], x)


# ===========================================================================
# caches
# ===========================================================================

def init_cache(cfg, batch_size: int, cache_len: int, *,
               device: Union[str, torch.device] = "cuda"):
    """Zero cache for decode: keys and values for ``cache_len`` positions
    (a ring of ``sliding_window`` slots when that is smaller), the SSM
    state and conv window, or (hybrid) both: ``{"ssm": ..., "attn":
    ...}`` with one K/V slot per group of ``attn_every`` layers, or
    (mla_moe) the latent cache of each stack, ``{"dense": {"c", "kr"},
    "moe": {"c", "kr"}}``."""
    _require_family(cfg)
    if cfg.family == "mla_moe":
        nd = cfg.first_dense_layers
        return {"dense": _latent_cache(cfg, nd, batch_size, cache_len,
                                       device),
                "moe": _latent_cache(cfg, cfg.num_layers - nd, batch_size,
                                     cache_len, device)}
    if cfg.family == "ssm":
        return _ssm_cache(cfg, cfg.num_layers, batch_size, device)
    if cfg.family == "hybrid":
        n_groups = _hybrid_groups(cfg)
        return {"ssm": _ssm_cache(cfg, cfg.num_layers, batch_size, device),
                "attn": _kv_cache(cfg, n_groups, batch_size, cache_len,
                                  device)}
    return _kv_cache(cfg, cfg.num_layers, batch_size, cache_len, device)


def _capacity(cfg, cache_len):
    return (min(cache_len, cfg.sliding_window) if cfg.sliding_window
            else cache_len)


def _kv_cache(cfg, n_layers, batch_size, cache_len, device):
    dt = L.cache_dtype_of(cfg)
    shape = (n_layers, batch_size, _capacity(cfg, cache_len),
             cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _latent_cache(cfg, n_layers, batch_size, cache_len, device):
    dt = L.cache_dtype_of(cfg)
    C = _capacity(cfg, cache_len)
    return {"c": torch.zeros((n_layers, batch_size, C, cfg.kv_lora_rank),
                             dtype=dt, device=device),
            "kr": torch.zeros((n_layers, batch_size, C,
                               cfg.qk_rope_head_dim), dtype=dt,
                              device=device)}


def _ssm_cache(cfg, n_layers, batch_size, device):
    return {
        "state": torch.zeros((n_layers, batch_size, cfg.ssm_nheads,
                              cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch_size, cfg.ssm_conv - 1,
                             S.conv_dim(cfg)),
                            dtype=L.dtype_of(cfg.compute_dtype),
                            device=device),
    }


# ===========================================================================
# decode step (one token, KV / state cache)
# ===========================================================================

def decode_step(cfg, params, cache, batch):
    """batch: {"token": (B, 1), "pos": int}.  Returns (logits (B,
    padded_vocab), cache), the cache updated in place."""
    _require_family(cfg)
    pos = int(batch["pos"])
    x = L.embed(cfg, params["embed"], batch["token"])
    if cfg.family in ("dense", "moe"):
        for i, p in enumerate(params["layers"]):
            x = _dense_decode(cfg, x, p, cache, i, pos)
    elif cfg.family == "mla_moe":
        for stack, i, p in _mla_layers(params):
            x = _mla_decode(cfg, x, p, cache[stack], i, pos)
    elif cfg.family == "ssm":
        for i, p in enumerate(params["layers"]):
            x = _ssm_decode(cfg, x, p, cache, i)
    else:
        for i, p in enumerate(params["layers"]):
            x = _ssm_decode(cfg, x, p, cache["ssm"], i)
            if (i + 1) % cfg.attn_every == 0:
                x = _dense_decode(cfg, x, params["shared_attn"],
                                  cache["attn"], i // cfg.attn_every, pos)
    x = L.apply_norm(cfg, x, params["ln_f"])
    return L.unembed(cfg, params["embed"], x)[:, 0], cache


def _dense_decode(cfg, x, p, cache, i, pos):
    """One dense block on one token, its key and value into slot ``i`` of
    ``cache`` ({"k", "v"}) in place."""
    hh = L.apply_norm(cfg, x, p["ln1"])
    o, _, _ = A.gqa_decode(cfg, p["attn"], hh, cache["k"][i], cache["v"][i],
                           pos, window=cfg.sliding_window)
    x = x + o
    hh = L.apply_norm(cfg, x, p["ln2"])
    return x + _ffn(cfg, p, hh)


def _mla_decode(cfg, x, p, cache, i, pos):
    """One MLA block on one token, its latent and rotary key into slot
    ``i`` of ``cache`` ({"c", "kr"}) in place."""
    hh = L.apply_norm(cfg, x, p["ln1"])
    o, _, _ = A.mla_decode(cfg, p["attn"], hh, cache["c"][i],
                           cache["kr"][i], pos, window=cfg.sliding_window)
    x = x + o
    hh = L.apply_norm(cfg, x, p["ln2"])
    return x + _ffn(cfg, p, hh)


def _ssm_decode(cfg, x, p, cache, i):
    """One SSM layer on one token, its state and conv window into slot
    ``i`` of ``cache`` ({"state", "conv"}) in place."""
    hh = L.apply_norm(cfg, x, p["ln"])
    o, st, cv = S.ssm_decode(cfg, p["ssm"], hh, cache["state"][i],
                             cache["conv"][i])
    cache["state"][i] = st
    cache["conv"][i] = cv
    return x + o


# ===========================================================================
# prefill (forward + cache construction)
# ===========================================================================

def prefill(cfg, params, batch):
    """Processes a full prompt and returns (last-token logits (B,
    padded_vocab), cache).  The cache holds the prompt's S positions, as
    the reference's does; sliding-window configs keep a ring of the last
    ``window`` positions, position p in slot p % C."""
    _require_family(cfg)
    tokens = batch["tokens"]
    B, Ssz = tokens.shape
    x = L.embed(cfg, params["embed"], tokens)

    positions = _positions(tokens)
    if cfg.family in ("dense", "moe"):
        cache = init_cache(cfg, B, Ssz, device=tokens.device)
        for i, p in enumerate(params["layers"]):
            x = _dense_prefill(cfg, x, p, positions, cache, i)
    elif cfg.family == "mla_moe":
        cache = init_cache(cfg, B, Ssz, device=tokens.device)
        for stack, i, p in _mla_layers(params):
            x = _mla_prefill(cfg, x, p, positions, cache[stack], i)
    else:
        states, convs = [], []
        if cfg.family == "hybrid":
            n_groups = _hybrid_groups(cfg)
            kv = _kv_cache(cfg, n_groups, B, Ssz, tokens.device)
        for i, p in enumerate(params["layers"]):
            hh = L.apply_norm(cfg, x, p["ln"])
            o, (st, cv) = S.ssm_forward(cfg, p["ssm"], hh, return_cache=True)
            x = x + o
            states.append(st)
            convs.append(cv)
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x = _dense_prefill(cfg, x, params["shared_attn"], positions,
                                   kv, i // cfg.attn_every)
        cache = {"state": torch.stack(states), "conv": torch.stack(convs)}
        if cfg.family == "hybrid":
            cache = {"ssm": cache, "attn": kv}

    x = L.apply_norm(cfg, x, params["ln_f"])
    logits = L.unembed(cfg, params["embed"], x[:, -1:])[:, 0]
    return logits, cache
