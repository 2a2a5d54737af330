"""The port's ``encdec`` (Whisper-tiny) and ``vlm`` (Qwen2-VL-7B)
families against the reference's JAX functions, on identical numpy
inputs and parameters (``params_from_numpy``), at the reduced configs in
float32: configs, init, M-RoPE, non-causal attention, forward, prefill
with both caches, decode, prefill against the decode-only loop; then the
card's dispatch rehearsed on the CPU (K7's launches, the gate that lets
non-causal calls through at any ``q_offset``), and K7's and K8's
gradients through their autograd Functions (the raw wrappers refuse an
input that requires grad).

The reference computes attention in XLA, so no Pallas interpret mode is
needed.  Tolerance: 1e-5 of the largest reference value.  Whisper's
reduced config groups its heads (4 over 2 kv heads); its published one
does not (6 / 6), so the ``.mha`` cut (4 / 4) covers that too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models.transformer import attention as RA
from repro.models.transformer import layers as RL
from repro.models.transformer import model as RM
from repro_torch.configs import base
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import segment_sum
from repro_torch.kernels import ssd_chunk as ssd
from repro_torch.launch import prefill_gap
from repro_torch.models.transformer import attention as A
from repro_torch.models.transformer import layers as L
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer import ssm as S

REL = 1e-5
MAX_SEQ = 64
ARCHS = ("whisper-tiny", "qwen2-vl-7b")
# model cuts: the reduced configs, and Whisper's with as many kv heads as
# query heads (the published 6 / 6 layout)
MODELS = ("whisper-tiny", "whisper-tiny.mha", "qwen2-vl-7b")
B, SD, SE = 2, 24, 40


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(model):
    arch, _, variant = model.partition(".")
    rcfg = ref_base.get_config(arch).reduced()
    cfg = base.get_config(arch).reduced()
    if variant == "mha":
        rcfg = rcfg.replace(num_kv_heads=rcfg.num_heads)
        cfg = cfg.replace(num_kv_heads=cfg.num_heads)
    return rcfg, cfg


@pytest.fixture(scope="module")
def models():
    out = {}
    for model in MODELS:
        rcfg, cfg = _cfgs(model)
        tree = jax.tree.map(np.asarray, RM.init_params(
            rcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ))
        out[model] = (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
                      M.params_from_numpy(cfg, tree, device="cpu"))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max(), scale)


def _image_positions(B_, n_text, gh, gw, n_after):
    """Qwen2-VL's M-RoPE layout (3, B, S): ``n_text`` text tokens (t = h
    = w = i), a gh x gw grid of merged patches (t = n_text, h = n_text +
    row, w = n_text + col), then ``n_after`` text tokens continuing from
    n_text + max(gh, gw)."""
    text = np.arange(n_text)
    rows, cols = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    img = np.stack([np.full(gh * gw, n_text), n_text + rows.ravel(),
                    n_text + cols.ravel()])
    after = n_text + max(gh, gw) + np.arange(n_after)
    pos = np.concatenate([np.stack([text] * 3), img, np.stack([after] * 3)],
                         axis=1)
    return np.broadcast_to(pos[:, None], (3, B_, pos.shape[1])
                           ).astype(np.int32)


def _batch(cfg, seed=0, S_=SD):
    """numpy inputs: Whisper's frames and tokens, or Qwen2-VL's embeddings
    at the image layout (4 text, a 2 x 4 grid, the rest text)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"enc_embeds": rng.standard_normal(
                    (B, SE, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size,
                                       (B, S_)).astype(np.int32)}
    return {"embeds": rng.standard_normal(
                (B, S_, cfg.d_model)).astype(np.float32),
            "positions": _image_positions(B, 4, 2, 4, S_ - 12)}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _shapes(tree, path=()):
    """{path: shape} of a param tree; a list of layers (the port's) counts
    as one stacked leaf per path, as the reference's leading layer axis."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _shapes(tree[key], path + (key,)).items()}
    if isinstance(tree, list):
        layers = [_shapes(t, path) for t in tree]
        return {k: (len(layers),) + v for k, v in layers[0].items()}
    return {path: tuple(tree.shape)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    """Every field of the published config and of its reduced() cut holds
    the reference's value (``encoder_layers`` and ``mrope_sections``
    included); the port keeps no field the reference lacks."""
    def kept(cfg):
        return {f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(base.ModelConfig)}

    ref_fields = {f.name for f in dataclasses.fields(ref_base.ModelConfig)}
    assert set(kept(base.get_config(arch))) <= ref_fields
    assert kept(base.get_config(arch)) == kept(ref_base.get_config(arch))
    assert kept(base.get_config(arch).reduced()) == \
        kept(ref_base.get_config(arch).reduced())
    for prop in ("resolved_head_dim", "padded_vocab"):
        assert getattr(base.get_config(arch), prop) == \
            getattr(ref_base.get_config(arch), prop)


@pytest.mark.parametrize("arch,family", [
    ("whisper_tiny", "encdec"), ("qwen2_vl_7b", "vlm"),
    ("whisper-tiny", "encdec"), ("qwen2-vl-7b", "vlm")])
def test_both_families_are_ported(arch, family):
    """Ids and dashed aliases resolve; every architecture loads; an
    unknown architecture still raises ``KeyError``."""
    assert base.get_config(arch).family == family
    assert family in base.PORTED_FAMILIES
    assert set(base.PORTED_CONFIGS) == set(base.ARCH_IDS)
    for other in base.ARCH_ALIASES:
        assert base.get_config(other).family == base.ARCH_FAMILIES[
            base.arch_module(other)]
    with pytest.raises(KeyError):
        base.get_config("no-such-model")


@pytest.mark.parametrize("model", MODELS)
def test_init_params_keys_and_shapes(model, models):
    """The port's own draw has the reference's keys and shapes at a
    ``max_seq`` of 64 (``enc_pos`` and ``dec_pos`` 64 rows), with the
    same parameter count; ``cast_params`` keeps a tree drawn there."""
    rcfg, rparams, cfg, params = models[model]
    mine = M.init_params(cfg, torch.Generator().manual_seed(0),
                         max_seq=MAX_SEQ, device="cpu")
    assert M.param_count(mine) == RM.param_count(rparams)
    assert _shapes(mine) == _shapes(rparams)
    if cfg.family == "encdec":
        for name in ("enc_pos", "dec_pos"):
            assert tuple(mine[name].shape) == (MAX_SEQ, cfg.d_model)
        assert "xattn" in mine["dec_layers"][0] and \
            "xattn" not in mine["enc_layers"][0]
    cast = M.cast_params(cfg.replace(param_dtype="bfloat16"), params)
    assert cast["embed"]["embedding"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# layers: M-RoPE, non-causal attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections", [(64, (8, 12, 12)),
                                         (128, (16, 24, 24))])
def test_mrope_under_the_image_layout(hd, sections):
    """M-RoPE's three position streams (text, then a grid of patches,
    then text) rotate as the reference's do."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 36, 3, hd)).astype(np.float32)
    pos = _image_positions(B, 6, 4, 6, 6)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       mrope_sections=sections)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                         mrope_sections=sections)
    _close(got, want)


def test_mrope_refuses_sections_that_do_not_cover_the_bands():
    x = torch.zeros(1, 2, 1, 64)
    with pytest.raises(ValueError, match="sections"):
        L.apply_rope(x, torch.zeros(3, 1, 2), 1e4, mrope_sections=(8, 8, 8))
    with pytest.raises(ValueError, match="sections"):
        L.apply_rope(x, torch.zeros(1, 2), 1e4, mrope_sections=(8, 12, 12))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_gqa_forward_causal_and_not(model, causal, models):
    """``gqa_forward(causal=)`` as the reference's, Qwen2-VL's under
    the image-layout positions."""
    rcfg, rparams, cfg, params = models[model]
    stack = "enc_layers" if cfg.family == "encdec" else "layers"
    p = params[stack][0]["attn"]
    rp = jax.tree.map(lambda a: a[0], rparams[stack])["attn"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, SD, cfg.d_model)).astype(np.float32)
    pos = (_image_positions(B, 4, 2, 4, SD - 12) if cfg.family == "vlm"
           else np.broadcast_to(np.arange(SD), (B, SD)).astype(np.int32))
    got = A.gqa_forward(cfg, p, torch.from_numpy(x),
                        torch.from_numpy(np.array(pos)), causal=causal)
    want = RA.gqa_forward(rcfg, rp, jnp.asarray(x), jnp.asarray(pos),
                          causal=causal)
    _close(got, want)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_forward_matches_reference(model, models):
    rcfg, rparams, cfg, params = models[model]
    batch = _batch(cfg)
    got = M.forward(cfg, params, _torch(batch))
    assert got.shape == (B, SD, cfg.padded_vocab)
    _close(got, RM.forward(rcfg, rparams, _jax(batch)))


@pytest.mark.parametrize("model", MODELS)
def test_prefill_logits_and_caches_match_reference(model, models):
    """Last-position logits and every cache leaf: Whisper's ``self`` (the
    prompt's positions) and ``cross`` (the encoder's), Qwen2-VL's K/V
    under the image layout."""
    rcfg, rparams, cfg, params = models[model]
    batch = _batch(cfg, seed=3)
    lg, cache = M.prefill(cfg, params, _torch(batch))
    rlg, rcache = RM.prefill(rcfg, rparams, _jax(batch))
    _close(lg, rlg)
    if cfg.family == "encdec":
        assert set(cache) == {"self", "cross"}
        assert cache["cross"]["k"].shape == (cfg.num_layers, B, SE,
                                             cfg.num_kv_heads, 64)
    got, want = _leaves(cache), _leaves(dict(rcache))
    assert len(got) == len(want) == (4 if cfg.family == "encdec" else 2)
    for g, w in zip(got, want):
        _close(g, w)


def _grow(cache, n, lib):
    """The self (or dense) K/V cache with ``n`` zero slots more; the cross
    cache untouched (zero slots there would enter its softmax)."""
    def pad(c):
        if lib is torch:
            return torch.cat([c, c.new_zeros(c.shape[:2] + (n,)
                                             + c.shape[3:])], dim=2)
        return jnp.pad(c, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
    if "self" in cache:
        return {"self": {k: pad(v) for k, v in cache["self"].items()},
                "cross": dict(cache["cross"])}
    return {k: pad(v) for k, v in cache.items()}


@pytest.mark.parametrize("model", MODELS)
def test_decode_steps_after_prefill_match_reference(model, models):
    """Three decode steps in the grown cache: the logits and the cache as
    the reference's.  Qwen2-VL rotates a decode token at its slot (as the
    reference's ``gqa_decode`` does), after an image-layout prompt too."""
    rcfg, rparams, cfg, params = models[model]
    batch = _batch(cfg, seed=4)
    _, cache = M.prefill(cfg, params, _torch(batch))
    _, rcache = RM.prefill(rcfg, rparams, _jax(batch))
    cache, rcache = _grow(cache, 3, torch), _grow(dict(rcache), 3, jnp)
    rng = np.random.default_rng(5)
    for i in range(3):
        if cfg.family == "vlm":
            emb = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
            step, rstep = {"embeds": torch.from_numpy(emb)}, \
                {"embeds": jnp.asarray(emb)}
        else:
            tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
            step, rstep = {"token": torch.from_numpy(tok)}, \
                {"token": jnp.asarray(tok)}
        lg, cache = M.decode_step(cfg, params, cache, dict(step, pos=SD + i))
        rlg, rcache = RM.decode_step(rcfg, rparams, rcache,
                                     dict(rstep, pos=jnp.int32(SD + i)))
        _close(lg, rlg)
    for g, w in zip(_leaves(cache), _leaves(rcache)):
        _close(g, w)


def _reference_decode_loop(rcfg, rparams, batch):
    """The reference's decode-only loop, as ``prefill_gap.decode_loop``
    runs the port's: Whisper's cross cache from a prefill over the first
    token, Qwen2-VL's embeddings one at a time."""
    if rcfg.family == "vlm":
        S_ = batch["embeds"].shape[1]
        cache = RM.init_cache(rcfg, B, S_)
        for t in range(S_):
            lg, cache = RM.decode_step(rcfg, rparams, cache, {
                "embeds": batch["embeds"][:, t:t + 1], "pos": jnp.int32(t)})
        return lg
    S_ = batch["tokens"].shape[1]
    lg, first = RM.prefill(rcfg, rparams, {
        "enc_embeds": batch["enc_embeds"], "tokens": batch["tokens"][:, :1]})
    cache = _grow(dict(first), S_ - 1, jnp)
    for t in range(1, S_):
        lg, cache = RM.decode_step(rcfg, rparams, cache, {
            "token": batch["tokens"][:, t:t + 1], "pos": jnp.int32(t)})
    return lg


@pytest.mark.parametrize("model", MODELS)
def test_prefill_against_the_decode_only_loop(model, models):
    """At text-style positions prefill and the decode-only loop compute
    one function: the port's two paths agree with each other and with the
    reference's decode-only loop."""
    rcfg, rparams, cfg, params = models[model]
    batch = _batch(cfg, seed=6, S_=16)
    if cfg.family == "vlm":
        batch["positions"] = np.broadcast_to(
            np.arange(16), (3, B, 16)).astype(np.int32)
    lg, _ = M.prefill(cfg, params, _torch(batch))
    loop = prefill_gap.decode_loop(cfg, params, _torch(batch))
    _close(loop, lg)
    _close(loop, _reference_decode_loop(rcfg, rparams, _jax(batch)))


@pytest.mark.parametrize("arch,flags", [
    ("whisper-tiny", ["--enc-len", "40"]), ("qwen2-vl-7b", [])])
def test_prefill_gap_takes_both_families(arch, flags):
    """The measuring tool's stub inputs from the seed: the two paths agree
    to roundoff, and the control (a token, or Qwen2-VL's embedding,
    changed) moves the logits far more."""
    flags = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
             "24", "--device", "cpu"] + flags
    same = prefill_gap.run(flags)
    assert same["max_abs_rel"] <= REL and same["argmax_agree"] == 1.0
    flip = prefill_gap.run(flags + ["--flip", "16"])
    assert flip["max_abs_rel"] >= 100 * max(same["max_abs_rel"], 1e-7)


@pytest.mark.parametrize("what", ["dec_pos", "self_cache"])
def test_decode_past_its_tables_raises(what, models):
    """Past ``dec_pos`` (the reference clamps the index silently) and
    past a full self cache (the reference overwrites its last slot) the
    port raises ``IndexError``."""
    _, _, cfg, params = models["whisper-tiny"]
    tok = torch.zeros((B, 1), dtype=torch.long)
    if what == "dec_pos":
        cache = M.init_cache(cfg, B, MAX_SEQ + 1, enc_len=SE, device="cpu")
        pos = MAX_SEQ
        with pytest.raises(IndexError, match="learned position table"):
            M.decode_step(cfg, params, cache, {"token": tok, "pos": pos})
    else:
        cache = M.init_cache(cfg, B, 8, enc_len=SE, device="cpu")
        with pytest.raises(IndexError, match="outside a cache of 8"):
            M.decode_step(cfg, params, cache, {"token": tok, "pos": 8})
    with pytest.raises(IndexError, match="learned position table"):
        M.forward(cfg, params, {"enc_embeds": torch.zeros(B, MAX_SEQ + 1,
                                                          cfg.d_model),
                                "tokens": tok})


# ---------------------------------------------------------------------------
# the card's dispatch, rehearsed on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """``pick`` choosing the kernel wrappers, stood in for by their plain
    versions behind the real autograd guard; returns each K7 call's
    (Sq, Skv, causal), launch plan and whether it wrote lse, and (as
    ``("k8",)``) each K8 call; the backward wrappers add ``("k7_bwd",)``
    and ``("k8_bwd",)``."""
    seen = []

    def k7(q, k, v, *, return_lse=False, **kw):
        segment_sum._refuse_grad("flash_attention_cuda (K7)",
                                 "FlashAttention", q, k, v)
        out = fa.flash_attention_plain(q, k, v, return_lse=return_lse, **kw)
        seen.append((q.shape[2], k.shape[2], kw["causal"],
                     fa.launch_plan(q, k, v, out[0] if return_lse else out),
                     return_lse))
        return out

    def k7_bwd(*args, **kw):
        seen.append(("k7_bwd",))
        return fa.flash_attention_bwd_plain(*args, **kw)

    def k8(x, dt, A_, Bm):
        segment_sum._refuse_grad("ssd_chunk_state_cuda (K8)",
                                 "SSDChunkState", x, dt, A_, Bm)
        seen.append(("k8",))
        return ssd.ssd_chunk_state_plain(x, dt, A_, Bm)

    def k8_bwd(*args):
        seen.append(("k8_bwd",))
        return ssd.ssd_chunk_state_bwd_plain(*args)

    monkeypatch.setattr(segment_sum, "pick", lambda card, plain, t: card)
    monkeypatch.setattr(fa, "flash_attention_cuda", k7)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", k7_bwd)
    monkeypatch.setattr(ssd, "ssd_chunk_state_cuda", k8)
    monkeypatch.setattr(ssd, "ssd_chunk_state_bwd_cuda", k8_bwd)
    return seen


@pytest.mark.parametrize("model", MODELS)
def test_k7_launches_per_prefill_and_decode_step(model, models, card):
    """Whisper: a prefill calls K7 once per encoder block (non-causal, Se
    x Se), once per decoder block's self attention (causal) and once per
    cross attention (Sd x Se); a decode step once per cross attention
    (1 x Se).  Qwen2-VL: once per layer in a prefill, never in decode.
    The values are the plain path's."""
    _, _, cfg, params = models[model]
    batch = _torch(_batch(cfg, seed=7))
    card.clear()
    got, cache = M.prefill(cfg, params, batch)
    calls = [c[:3] for c in card]
    nl = cfg.num_layers
    if cfg.family == "encdec":
        assert calls == [(SE, SE, False)] * cfg.encoder_layers + [
            (SD, SD, True), (SD, SE, False)] * nl
    else:
        assert calls == [(SD, SD, True)] * nl
    assert all(c[3]["tile_width"] == 64 for c in card)
    card.clear()
    cache = _grow(cache, 1, torch)
    step = ({"embeds": batch["embeds"][:, :1]} if cfg.family == "vlm"
            else {"token": batch["tokens"][:, :1]})
    M.decode_step(cfg, params, cache, dict(step, pos=SD))
    assert [c[:3] for c in card] == (
        [(1, SE, False)] * nl if cfg.family == "encdec" else [])


@pytest.mark.parametrize("call,ok", [
    ("noncausal_offset0", True), ("causal_misaligned", False),
    ("window_misaligned", False), ("kv_valid_len", False)])
def test_the_card_gate_reads_the_offset_only_under_a_mask(call, ok, card):
    """K7 aligns queries to the end of the kv axis, and only its masks
    read that: a non-causal call without a window runs at ``q_offset`` 0
    with Sq != Skv; a causal or windowed call at another offset, and any
    ``kv_valid_len``, raise."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((1, 3, 4, 64)).astype(
        np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 9, 2, 64)).astype(
        np.float32))
    kw = {"noncausal_offset0": dict(causal=False, q_offset=0),
          "causal_misaligned": dict(causal=True, q_offset=0),
          "window_misaligned": dict(causal=False, q_offset=0, window=4),
          "kv_valid_len": dict(causal=False, q_offset=0,
                               kv_valid_len=5)}[call]
    if ok:
        got = L.attention(q, kv, kv, **kw)
        want = RL.attention(jnp.asarray(q.numpy()), jnp.asarray(kv.numpy()),
                            jnp.asarray(kv.numpy()), **kw)
        _close(got, want)
        assert [c[:3] for c in card] == [(3, 9, False)]
    else:
        with pytest.raises(NotImplementedError):
            L.attention(q, kv, kv, **kw)
        assert not card


def _ssd_inputs(requires_grad):
    rng = np.random.default_rng(9)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x, Bm, Cm = t(1, 16, 4, 8), t(1, 16, 1, 8), t(1, 16, 1, 8)
    dt = torch.nn.functional.softplus(t(1, 16, 4))
    A_ = -torch.arange(1, 5, dtype=torch.float32)
    x.requires_grad_(requires_grad)
    return x, dt, A_, Bm, Cm


def _attn_inputs(requires_grad):
    rng = np.random.default_rng(10)
    q, k = (torch.from_numpy(rng.standard_normal((1, 8, 2, 64)).astype(
        np.float32)) for _ in range(2))
    return q.requires_grad_(requires_grad), k


@pytest.mark.parametrize("kernel", ["attention", "ssd_chunked"])
@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_k7_and_k8_give_their_gradient_through_the_functions(kernel, mode,
                                                            card,
                                                            monkeypatch):
    """On the card (rehearsed), with grad on an input that requires it,
    ``attention`` and ``ssd_chunked`` run K7 / K8 through their autograd
    Functions (K7 writing its lse) and the backward through the VJP
    wrappers, giving the plain path's gradient; the raw forward wrappers
    still refuse such an input, naming the Function.  Under ``no_grad``
    or ``inference_mode`` the same calls run the forward alone (no lse
    written, so none saved) and return the plain path's values."""
    def run(requires_grad):
        if kernel == "attention":
            q, k = _attn_inputs(requires_grad)
            return q, L.attention(q, k, k, causal=True, q_offset=0)
        x, dt, A_, Bm, Cm = _ssd_inputs(requires_grad)
        return x, S.ssd_chunked(x, dt, A_, Bm, Cm, chunk=8)

    name = "k7" if kernel == "attention" else "k8"
    if mode == "grad":
        leaf, got = run(True)
        (g,) = torch.autograd.grad(got.square().sum(), leaf)
        if kernel == "attention":
            assert [c[4] for c in card if len(c) == 5] == [True]
            with pytest.raises(NotImplementedError, match="FlashAttention"):
                fa.flash_attention_cuda(leaf.transpose(1, 2),
                                        leaf.transpose(1, 2),
                                        leaf.transpose(1, 2))
        else:
            with pytest.raises(NotImplementedError, match="SSDChunkState"):
                ssd.ssd_chunk_state_cuda(*_ssd_inputs(True)[:4])
        assert ("k7_bwd",) in card or ("k8_bwd",) in card
    else:
        ctx = torch.no_grad() if mode == "no_grad" else \
            torch.inference_mode()
        with ctx:
            got = run(True)[1]
        assert not any(c[-1] is True for c in card if len(c) == 5)
        assert ("k7_bwd",) not in card and ("k8_bwd",) not in card
    assert card, f"{name} never ran"
    monkeypatch.setattr(segment_sum, "pick", lambda card, plain, t: plain)
    leaf, want = run(True)
    assert want.requires_grad           # the plain path keeps its graph
    torch.testing.assert_close(got.detach(), want.detach(), rtol=0, atol=0)
    if mode == "grad":
        (w,) = torch.autograd.grad(want.square().sum(), leaf)
        _close(g, w.numpy())
