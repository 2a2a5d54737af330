"""The transformer zoo, all seven families of the reference's
``models/transformer/model.py`` (``dense``, ``ssm``, ``hybrid``,
``moe``, ``mla_moe``, ``encdec``, ``vlm``), in PyTorch: init, forward,
the loss and train step (:func:`loss_fn`, :func:`make_train_step`, on
the card through K7's and K8's VJP kernels), prefill (forward + cache)
and one-token decode.

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
and ``(n_layers, B, C, qk_rope_head_dim)``.  The ``vlm`` family
(Qwen2-VL) is the dense one fed precomputed embeddings (its vision
tower stubbed, as in the reference) with M-RoPE's (3, B, S) positions.
The ``encdec`` family (Whisper) runs ``params["enc_layers"]``
(non-causal dense blocks over the frame embeddings plus ``enc_pos``,
then ``ln_enc``) and ``params["dec_layers"]`` (causal self attention,
cross attention over the encoder output, the MLP; tokens plus
``dec_pos``); its cache is ``{"self": {"k", "v"}, "cross": {"k",
"v"}}``, the cross keys and values computed once by :func:`prefill`.

Batch conventions:
  forward / prefill:  {"tokens": (B, S) int}
                      vlm:    {"embeds": (B, S, D), "positions": (3, B, S)}
                      encdec: {"enc_embeds": (B, Se, D), "tokens": (B, S)}
  decode:             {"token": (B, 1) int, "pos": int}
                      vlm:    {"embeds": (B, 1, D), "pos": int}
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import PORTED_FAMILIES
from repro_torch.launch import sharding as shd
from repro_torch.models.transformer import attention as A
from repro_torch.models.transformer import layers as L
from repro_torch.models.transformer import moe as MOE
from repro_torch.models.transformer import ssm as S


def _require_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
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


def _init_encdec_layer(cfg, gen, dtype, device, cross: bool):
    p = _init_dense_layer(cfg, gen, dtype, device)
    if cross:
        p["xattn"] = A.init_gqa(cfg, gen, dtype, device)
        p["ln_x"] = L.init_norm(cfg, cfg.d_model, device)
    return p


#: the reference's default length of Whisper's learned position tables
MAX_SEQ = 4096


def init_params(cfg, gen: torch.Generator, *, max_seq: int = MAX_SEQ,
                device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Random params with the reference's distributions, drawn from
    ``gen`` (a generator on ``device``).  ``max_seq``: the rows of the
    ``encdec`` family's learned position tables ``enc_pos`` and
    ``dec_pos`` (the longest encoder input and decoder sequence)."""
    _require_family(cfg)
    device = torch.device(device)
    dtype = L.dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {"embed": L.init_embed(cfg, gen, dtype, device),
                              "ln_f": L.init_norm(cfg, cfg.d_model, device)}
    if cfg.family == "encdec":
        params["enc_layers"] = [
            _init_encdec_layer(cfg, gen, dtype, device, cross=False)
            for _ in range(cfg.encoder_layers)]
        params["dec_layers"] = [
            _init_encdec_layer(cfg, gen, dtype, device, cross=True)
            for _ in range(cfg.num_layers)]
        params["ln_enc"] = L.init_norm(cfg, cfg.d_model, device)
        for name in ("enc_pos", "dec_pos"):
            params[name] = L.normal(gen, (max_seq, cfg.d_model), device,
                                    0.02, dtype)
        return params
    if cfg.family == "mla_moe":
        nd = cfg.first_dense_layers
        params["dense_layers"] = [_init_mla_dense_layer(cfg, gen, dtype,
                                                        device)
                                  for _ in range(nd)]
        params["moe_layers"] = [_init_mla_moe_layer(cfg, gen, dtype, device)
                                for _ in range(cfg.num_layers - nd)]
        return params
    layer = {"dense": _init_dense_layer, "vlm": _init_dense_layer,
             "moe": _init_moe_layer}.get(cfg.family, _init_ssm_layer)
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
STACKS = frozenset({"layers", "dense_layers", "moe_layers", "enc_layers",
                    "dec_layers"})


def _map(fn, want, given):
    """``fn(want_leaf, given_leaf)`` over two param trees of one layout."""
    if isinstance(want, torch.Tensor):
        return fn(want, given)
    if isinstance(want, Mapping):
        return {k: _map(fn, want[k], given[k]) for k in want}
    return [_map(fn, w, g) for w, g in zip(want, given)]


def _max_seq(tree) -> int:
    """The ``max_seq`` a param tree was drawn at: its learned position
    tables' rows (``encdec``), else the default."""
    return int(np.shape(tree["enc_pos"])[0]) if "enc_pos" in tree \
        else MAX_SEQ


def cast_params(cfg, params) -> Dict[str, Any]:
    """``params`` (of another dtype config of the same architecture) with
    each leaf in the dtype ``init_params(cfg)`` gives it: weights in
    ``cfg.param_dtype``, norms and SSM scalars in float32."""
    skeleton = init_params(cfg, torch.Generator(), device="meta",
                           max_seq=_max_seq(params))
    return _map(lambda w, g: g.to(w.dtype), skeleton, params)


def params_from_numpy(cfg, tree: Mapping, device: Union[str, torch.device]
                      = "cuda") -> Dict[str, Any]:
    """The port's params holding the reference's: ``tree`` is the
    reference's ``init_params`` pytree mapped to numpy, with stacked
    ``(n_layers, ...)`` leaves under ``layers`` (or, in ``mla_moe``,
    ``dense_layers`` and ``moe_layers``, in ``encdec`` ``enc_layers`` and
    ``dec_layers``; the hybrid's ``shared_attn`` is one unstacked layer),
    drawn at any ``max_seq`` (read from ``enc_pos``).  Keys and shapes
    must match the port's own; each leaf takes the port's dtype for
    it."""
    skeleton = init_params(cfg, torch.Generator(), device="meta",
                           max_seq=_max_seq(tree))
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
    x = shd.gather_seq(x)
    if cfg.moe_impl == "ep":
        from repro_torch.core.parallel import moe_expert_parallel
        y = moe_expert_parallel(cfg, p, x,
                                capacity_factor=cfg.moe_capacity_factor)
    else:
        y = MOE.moe_block(cfg, p, x)
    return shd.scatter_seq(y)


def _ffn(cfg, p, h):
    """The feed-forward half of an attention block: the experts in a
    layer that has them (``moe``, ``mla_moe``'s MoE layers), the MLP in
    any other."""
    if "moe" in p:
        return _moe(cfg, p["moe"], h)
    return L.mlp(cfg, h, p["mlp"])


def _dense_body(cfg, x, p, positions, *, causal=True):
    h = L.apply_norm(cfg, x, p["ln1"])
    x = x + A.gqa_forward(cfg, p["attn"], h, positions, causal=causal)
    h = L.apply_norm(cfg, x, p["ln2"])
    return shd.constrain(x + _ffn(cfg, p, h), "act")


def _ssm_body(cfg, x, p):
    h = L.apply_norm(cfg, x, p["ln"])
    return shd.constrain(x + S.ssm_forward(cfg, p["ssm"], h), "act")


def _mla_body(cfg, x, p, positions):
    h = L.apply_norm(cfg, x, p["ln1"])
    x = x + A.mla_forward(cfg, p["attn"], h, positions)
    h = L.apply_norm(cfg, x, p["ln2"])
    return shd.constrain(x + _ffn(cfg, p, h), "act")


def _top(params):
    """The params outside the layer stacks (embeddings, final norms,
    learned positions) as the model computes with them
    (:func:`~repro_torch.launch.sharding.gather_params`)."""
    return shd.gather_params({k: v for k, v in params.items()
                              if k not in STACKS and k != "shared_attn"})


def _layer(body, x, p, *rest, remat=False, **kw):
    """``body(x, p, *rest, **kw)`` for one layer, its params ``p`` as the
    layer computes with them (:func:`~repro_torch.launch.sharding.
    gather_params`: the FSDP shards gathered; ``p`` itself unsharded);
    with ``remat`` under ``torch.utils.checkpoint`` (non-reentrant), so
    backward recomputes the layer from its input, as the reference's
    ``jax.checkpoint`` per layer does."""
    def run(h):
        return body(h, shd.gather_params(p), *rest, **kw)
    if remat:
        from torch.utils.checkpoint import checkpoint
        return checkpoint(run, x, use_reentrant=False)
    return run(x)


def _mla_layers(params):
    """``mla_moe``'s layers in order, each with its cache stack's name and
    its index there: the dense ones, then the MoE ones."""
    for stack in ("dense", "moe"):
        for i, p in enumerate(params[f"{stack}_layers"]):
            yield stack, i, p


def _to_ring(dst, src):
    """The prompt's rows ``src`` (B, S, ...) into one layer's cache ``dst``
    (B, C, ...): position p in ring slot p % C, the last C positions kept
    (C == S without a window).  A DTensor cache (S >= C, as
    :func:`prefill` sizes it) takes the last C rows rolled into their
    slots, a copy into its own placement."""
    Ssz, C = src.shape[1], dst.shape[1]
    if shd.sharded(dst) and Ssz >= C:
        tail, shift = src[:, Ssz - C:], (Ssz - C) % C
        dst.copy_((torch.roll(tail, shift, 1) if shift else tail).to(
            dst.dtype))
        return
    kept = torch.arange(max(0, Ssz - C), Ssz, device=src.device)
    dst[:, kept % C] = src[:, kept].to(dst.dtype)


def _new_cache(like, build):
    """``build(device)`` (a zero cache), on ``like``'s device; when
    ``like`` is a DTensor under sharding rules, built on the meta device
    and laid out by the rules' cache specs (zero shards, nothing global
    allocated)."""
    rules = shd.sharded(like)
    if rules is None:
        return build(like.device)
    meta = build("meta")
    return shd.distribute(meta, shd.cache_specs(meta, rules.mesh, rules),
                          rules.mesh)


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


def _positions(B, Ssz, device):
    return torch.arange(Ssz, device=device)[None].expand(B, Ssz)


def _inputs(cfg, params, batch):
    """The first block's input (B, S, D) and the positions: ``vlm``'s
    embeddings and M-RoPE positions (3, B, S) as given, else the token
    embeddings and 0..S-1."""
    if cfg.family == "vlm":
        x = batch["embeds"].to(L.dtype_of(cfg.compute_dtype))
        return x, batch["positions"]
    x = L.embed(cfg, params["embed"], batch["tokens"])
    return x, _positions(x.shape[0], x.shape[1], x.device)


def _learned(table, n: int):
    """The first ``n`` rows of a learned position table (``enc_pos``,
    ``dec_pos``); ``IndexError`` past its ``max_seq`` rows (where the
    reference fails in a shape mismatch, or clamps an index)."""
    if not 0 <= n <= table.shape[0]:
        raise IndexError(f"{n} positions outside a learned position table "
                         f"of {table.shape[0]} rows (init_params' max_seq)")
    return table[:n]


def _encode(cfg, params, enc_embeds, remat=False):
    """Whisper's encoder: the frame embeddings plus ``enc_pos``, the
    non-causal dense blocks, ``ln_enc``; (B, Se, D) in the compute
    dtype."""
    dt = L.dtype_of(cfg.compute_dtype)
    enc = enc_embeds.to(dt)
    B, Se = enc.shape[:2]
    enc = enc + _learned(params["enc_pos"], Se).to(dt)
    positions = _positions(B, Se, enc.device)
    for p in params["enc_layers"]:
        enc = _layer(lambda h, q: _dense_body(cfg, h, q, positions,
                                              causal=False),
                     enc, p, remat=remat)
    # the cross attention's keys and values read the whole sequence
    return shd.gather_seq(L.apply_norm(cfg, enc, params["ln_enc"]))


def _dec_body(cfg, x, p, positions, xk, xv):
    """One Whisper decoder block over a prompt: causal self attention,
    cross attention over the encoder's keys and values ``xk``, ``xv``
    (``attention._kv`` of the encoder output), the MLP.  Returns (x, (k,
    v)), the self attention's keys and values beside."""
    hh = L.apply_norm(cfg, x, p["ln1"])
    o, kv = A.gqa_forward(cfg, p["attn"], hh, positions, causal=True,
                          return_kv=True)
    x = x + o
    hh = L.apply_norm(cfg, x, p["ln_x"])
    x = x + A.cross_attention(cfg, p["xattn"], hh, xk, xv)
    hh = L.apply_norm(cfg, x, p["ln2"])
    return shd.constrain(x + L.mlp(cfg, hh, p["mlp"]), "act"), kv


def _encdec(cfg, params, batch, cache=None, remat=False):
    """Whisper's encoder over ``batch["enc_embeds"]``, then its decoder
    over ``batch["tokens"]`` (plus ``dec_pos``): each block's causal self
    attention, cross attention over the encoder output, the MLP.  Returns
    the last block's output (B, S, D); with ``cache`` (``{"self",
    "cross"}`` of the prompt's and the encoder's lengths) each block's
    self and cross keys and values are written into it."""
    enc = _encode(cfg, params, batch["enc_embeds"], remat)
    tokens = batch["tokens"]
    B, Sd = tokens.shape
    x = L.embed(cfg, params["embed"], tokens) + _learned(
        params["dec_pos"], Sd).to(enc.dtype)
    positions = _positions(B, Sd, x.device)
    for i, p in enumerate(params["dec_layers"]):
        if cache is None:
            x = _layer(lambda h, q: _dec_body(
                cfg, h, q, positions, *A._kv(cfg, q["xattn"], enc))[0],
                x, p, remat=remat)
            continue
        p = shd.gather_params(p)
        xk, xv = A._kv(cfg, p["xattn"], enc)
        x, (k, v) = _dec_body(cfg, x, p, positions, xk, xv)
        for name, t in (("self", (k, v)), ("cross", (xk, xv))):
            cache[name]["k"][i].copy_(t[0])
            cache[name]["v"][i].copy_(t[1])
    return x


# ===========================================================================
# forward (scoring path; no cache)
# ===========================================================================

def forward(cfg, params, batch, *, remat=False) -> torch.Tensor:
    """Logits (B, S, padded_vocab) of the batch (the module's batch
    conventions).  Attention is causal over the whole sequence (as the
    reference's ``forward`` with its default ``window=0``, sliding-window
    configs included); Whisper's encoder is non-causal.  ``remat``: each
    layer under ``torch.utils.checkpoint`` (:func:`_layer`; the hybrid's
    shared block outside it, as in the reference)."""
    _require_family(cfg)
    top = _top(params)
    if cfg.family == "encdec":
        x = _encdec(cfg, {**params, **top}, batch, remat=remat)
        x = L.apply_norm(cfg, x, top["ln_f"])
        return shd.constrain(L.unembed(cfg, top["embed"], x), "logits")
    x, positions = _inputs(cfg, top, batch)
    x = shd.constrain(x, "act")
    if cfg.family in ("dense", "moe", "vlm"):
        for p in params["layers"]:
            x = _layer(lambda h, q: _dense_body(cfg, h, q, positions), x, p,
                       remat=remat)
    elif cfg.family == "mla_moe":
        for _, _, p in _mla_layers(params):
            x = _layer(lambda h, q: _mla_body(cfg, h, q, positions), x, p,
                       remat=remat)
    else:
        if cfg.family == "hybrid":
            shared = shd.gather_params(params["shared_attn"])
        for i, p in enumerate(params["layers"]):
            x = _layer(lambda h, q: _ssm_body(cfg, h, q), x, p, remat=remat)
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x = _dense_body(cfg, x, shared, positions)
    x = L.apply_norm(cfg, x, top["ln_f"])
    return shd.constrain(L.unembed(cfg, top["embed"], x), "logits")


# ===========================================================================
# loss / train step
# ===========================================================================

def loss_fn(cfg, params, batch, *, remat=False) -> torch.Tensor:
    """Mean next-token cross entropy (``model.py:300``): the logits cast
    to float32, their log-sum-exp over the padded vocabulary minus the
    gold logit of ``batch["labels"]`` (B, S).  ``remat`` as
    :func:`forward`'s."""
    logits = forward(cfg, params, batch, remat=remat).float()
    labels = batch["labels"].long()
    rules = shd.sharded(logits)
    if rules is not None:
        return torch.mean(_nll_sharded(rules, logits, labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


def _nll_sharded(rules, logits, labels):
    """``logz - gold`` (B, S) of float32 logits whose vocabulary is split
    over ``model`` (the rules' ``logits`` spec), on the shards: each rank
    takes its vocabulary slice's max (all-reduced, max), its sum of
    ``exp(logit - max)`` and its gold logit where the label falls in its
    slice (both all-reduced, sum); the vocabulary is never gathered.  The
    max is taken without gradient: log-sum-exp's gradient does not
    depend on it."""
    from torch.distributed.tensor import Partial
    b = rules.batch_axis
    spec = rules.spec_for("logits", logits.shape)
    row = spec[:2]
    names = rules.mesh.mesh_dim_names

    def partial(op):
        return tuple(Partial(op) if a == "model" else q for a, q in
                     zip(names, shd.placements(row, rules.mesh)))

    m = shd.on_shards(lambda lg: lg.detach().amax(-1), [spec],
                      partial("max"), rules)(logits)
    m = m.redistribute(rules.mesh, shd.placements(row, rules.mesh))

    def local(lg, mx, lb):
        lo = rules.mesh.get_local_rank("model") * lg.shape[-1]
        se = torch.exp(lg - mx[..., None]).sum(-1)
        mine = (lb >= lo) & (lb < lo + lg.shape[-1])
        idx = torch.where(mine, lb - lo, torch.zeros_like(lb))
        gold = torch.gather(lg, -1, idx[..., None])[..., 0]
        return se, torch.where(mine, gold, torch.zeros_like(gold))

    se, gold = shd.on_shards(local, [spec, row, (b, None)],
                             [partial("sum"), partial("sum")],
                             rules)(logits, m, labels)
    place = shd.placements(row, rules.mesh)
    se, gold = se.redistribute(rules.mesh, place), gold.redistribute(
        rules.mesh, place)
    return torch.log(se) + m - gold


def trainable(params) -> list:
    """The param tree's leaves, each set to require grad: what the
    optimizer of :func:`make_train_step` steps over."""
    return [t.requires_grad_(True) for t in _leaves(params)]


def make_train_step(cfg, optimizer, *, remat=True):
    """``step(params, batch) -> {"loss", "grad_norm"}`` (``model.py:310``):
    the loss and its gradients by autograd (on the card through K7's and
    K8's backward kernels; with ``remat``, the reference's default, each
    layer recomputed in the backward, so K7 and K8 run their forward
    again there), the global norm of the float32 gradients
    taken before the optimizer clips them, then one ``optimizer.step()``
    (the port's AdamW clips to its own global norm, as the reference's
    does).  ``params``' leaves are the optimizer's (:func:`trainable`);
    the gradients stay in their ``.grad`` until the next step clears
    them.  Both metrics are 0-d float32 tensors on the params' device."""

    def step(params, batch):
        leaves = list(_leaves(params))
        for p in leaves:
            p.grad = None
        loss = loss_fn(cfg, params, batch, remat=remat)
        loss.backward()
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(torch.square(p.grad.float()))
                                   for p in leaves if p.grad is not None))
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return step


# ===========================================================================
# caches
# ===========================================================================

def init_cache(cfg, batch_size: int, cache_len: int, *, enc_len: int = 0,
               device: Union[str, torch.device] = "cuda"):
    """Zero cache for decode: keys and values for ``cache_len`` positions
    (a ring of ``sliding_window`` slots when that is smaller), the SSM
    state and conv window, or (hybrid) both: ``{"ssm": ..., "attn":
    ...}`` with one K/V slot per group of ``attn_every`` layers, or
    (mla_moe) the latent cache of each stack, ``{"dense": {"c", "kr"},
    "moe": {"c", "kr"}}``, or (encdec) ``{"self": ..., "cross": ...}``,
    the decoder's keys and values and the encoder's ``enc_len``
    positions (which :func:`prefill` fills)."""
    _require_family(cfg)
    if cfg.family == "encdec":
        return {"self": _kv_cache(cfg, cfg.num_layers, batch_size,
                                  cache_len, device),
                "cross": _kv_cache(cfg, cfg.num_layers, batch_size, enc_len,
                                   device, ring=False)}
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


def _kv_cache(cfg, n_layers, batch_size, cache_len, device, *, ring=True):
    """Zero keys and values (n_layers, B, C, K, hd): C the ring's
    capacity (:func:`_capacity`), or with ``ring=False`` ``cache_len``."""
    dt = L.cache_dtype_of(cfg)
    C = _capacity(cfg, cache_len) if ring else cache_len
    shape = (n_layers, batch_size, C, cfg.num_kv_heads,
             cfg.resolved_head_dim)
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
    """batch: {"token": (B, 1), "pos": int} (vlm: {"embeds": (B, 1, D),
    "pos"}).  Returns (logits (B, padded_vocab), cache), the cache updated
    in place.  encdec adds ``dec_pos[pos]`` (``IndexError`` past its
    rows) and attends over the cross cache that :func:`prefill` built."""
    _require_family(cfg)
    pos = int(batch["pos"])
    top = _top(params)
    if cfg.family == "vlm":
        x = batch["embeds"].to(L.dtype_of(cfg.compute_dtype))
    else:
        x = L.embed(cfg, top["embed"], batch["token"])
    x = shd.constrain(x, "act")
    gp = shd.gather_params
    if cfg.family == "encdec":
        # row pos of dec_pos (IndexError past its max_seq rows)
        x = x + _learned(top["dec_pos"], pos + 1)[pos].to(x.dtype)
        for i, p in enumerate(params["dec_layers"]):
            x = _encdec_decode(cfg, x, gp(p), cache, i, pos)
    elif cfg.family in ("dense", "moe", "vlm"):
        for i, p in enumerate(params["layers"]):
            x = _dense_decode(cfg, x, gp(p), cache, i, pos)
    elif cfg.family == "mla_moe":
        for stack, i, p in _mla_layers(params):
            x = _mla_decode(cfg, x, gp(p), cache[stack], i, pos)
    elif cfg.family == "ssm":
        for i, p in enumerate(params["layers"]):
            x = _ssm_decode(cfg, x, gp(p), cache, i)
    else:
        shared = gp(params["shared_attn"])
        for i, p in enumerate(params["layers"]):
            x = _ssm_decode(cfg, x, gp(p), cache["ssm"], i)
            if (i + 1) % cfg.attn_every == 0:
                x = _dense_decode(cfg, x, shared, cache["attn"],
                                  i // cfg.attn_every, pos)
    x = L.apply_norm(cfg, x, top["ln_f"])
    return L.unembed(cfg, top["embed"], x)[:, 0], cache


def _dense_decode(cfg, x, p, cache, i, pos):
    """One dense block on one token, its key and value into slot ``i`` of
    ``cache`` ({"k", "v"}) in place."""
    hh = L.apply_norm(cfg, x, p["ln1"])
    o, _, _ = A.gqa_decode(cfg, p["attn"], hh, cache["k"][i], cache["v"][i],
                           pos, window=cfg.sliding_window)
    x = x + o
    hh = L.apply_norm(cfg, x, p["ln2"])
    return x + _ffn(cfg, p, hh)


def _encdec_decode(cfg, x, p, cache, i, pos):
    """One Whisper decoder block on one token: its self key and value into
    slot ``i`` of ``cache["self"]`` in place, cross attention over slot
    ``i`` of ``cache["cross"]``."""
    hh = L.apply_norm(cfg, x, p["ln1"])
    o, _, _ = A.gqa_decode(cfg, p["attn"], hh, cache["self"]["k"][i],
                           cache["self"]["v"][i], pos,
                           window=cfg.sliding_window)
    x = x + o
    hh = L.apply_norm(cfg, x, p["ln_x"])
    x = x + A.cross_attention(cfg, p["xattn"], hh, cache["cross"]["k"][i],
                              cache["cross"]["v"][i])
    hh = L.apply_norm(cfg, x, p["ln2"])
    return x + L.mlp(cfg, hh, p["mlp"])


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
    ``window`` positions, position p in slot p % C.  encdec's holds the
    decoder's S positions under ``"self"`` and the encoder's keys and
    values under ``"cross"``."""
    _require_family(cfg)
    top = _top(params)
    if cfg.family == "encdec":
        B, Sd = batch["tokens"].shape
        Se = batch["enc_embeds"].shape[1]
        cache = _new_cache(batch["tokens"], lambda dev: {
            "self": _kv_cache(cfg, cfg.num_layers, B, Sd, dev, ring=False),
            "cross": _kv_cache(cfg, cfg.num_layers, B, Se, dev,
                               ring=False)})
        x = shd.gather_seq(_encdec(cfg, {**params, **top}, batch,
                                   cache))[:, -1:]
        x = L.apply_norm(cfg, x, top["ln_f"])
        return L.unembed(cfg, top["embed"], x)[:, 0], cache
    x, positions = _inputs(cfg, top, batch)
    x = shd.constrain(x, "act")
    B, Ssz = x.shape[0], x.shape[1]
    if cfg.family in ("dense", "moe", "vlm"):
        cache = _new_cache(x, lambda dev: init_cache(cfg, B, Ssz,
                                                     device=dev))
        for i, p in enumerate(params["layers"]):
            x = _dense_prefill(cfg, x, shd.gather_params(p), positions,
                               cache, i)
    elif cfg.family == "mla_moe":
        cache = _new_cache(x, lambda dev: init_cache(cfg, B, Ssz,
                                                     device=dev))
        for stack, i, p in _mla_layers(params):
            x = _mla_prefill(cfg, x, shd.gather_params(p), positions,
                             cache[stack], i)
    else:
        states, convs = [], []
        if cfg.family == "hybrid":
            n_groups = _hybrid_groups(cfg)
            kv = _new_cache(x, lambda dev: _kv_cache(cfg, n_groups, B, Ssz,
                                                     dev))
            shared = shd.gather_params(params["shared_attn"])
        for i, p in enumerate(params["layers"]):
            p = shd.gather_params(p)
            hh = L.apply_norm(cfg, x, p["ln"])
            o, (st, cv) = S.ssm_forward(cfg, p["ssm"], hh, return_cache=True)
            x = x + o
            states.append(st)
            convs.append(cv)
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x = _dense_prefill(cfg, x, shared, positions, kv,
                                   i // cfg.attn_every)
        cache = {"state": torch.stack(states), "conv": torch.stack(convs)}
        if cfg.family == "hybrid":
            cache = {"ssm": cache, "attn": kv}

    # the last position (its rows gathered where the sequence is split)
    x = L.apply_norm(cfg, shd.gather_seq(x), top["ln_f"])
    logits = L.unembed(cfg, top["embed"], x[:, -1:])[:, 0]
    return logits, cache
