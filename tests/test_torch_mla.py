"""The port's ``mla_moe`` family (DeepSeek-V3: MLA blocks, the first
``first_dense_layers`` with a dense MLP, the rest with the experts)
against the reference's JAX functions, on identical numpy inputs and
parameters, in float32: ``init_mla``, ``mla_forward`` (with its latent
cache rows), the absorbed ``mla_decode``, and the family's ``forward``,
``prefill`` (logits and the latent cache) and ``decode_step``.  The
reference computes MLA's attention in XLA (``L.attention`` reads v's
width from v), so no Pallas interpret mode is needed.

Models run at the reduced config (2 layers: 1 dense, 1 MoE; 4 heads, q/k
48 and v 32, 4 experts, a shared expert, factor 8.0) and at the same cut
with DeepSeek-V3's head widths (q/k 192 = 128 + 64 rotary, v 128), the
pair K7 takes on the card.  Tolerance: 1e-5 of the largest reference
value; prefill against the port's own decode-only loop 1e-4 of the
largest logit (the reference's own two paths differ by 3.1e-6 of it
here).  K7's plan at MLA's widths and its dispatch from a prefill are
rehearsed on the CPU with the card's wrapper stood in for by the plain
version.
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
from repro_torch.launch import prefill_gap
from repro_torch.models.transformer import attention as A
from repro_torch.models.transformer import layers as L
from repro_torch.models.transformer import model as M

ARCH = "deepseek-v3-671b"
#: the reduced config, and the same cut at the published head widths
CUTS = {"reduced": {},
        "published_heads": dict(qk_nope_head_dim=128, qk_rope_head_dim=64,
                                v_head_dim=128)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (ref_base.get_config(ARCH).reduced().replace(**kw),
            base.get_config(ARCH).reduced().replace(**kw))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _torch_tree(p):
    if isinstance(p, dict):
        return {k: _torch_tree(v) for k, v in p.items()}
    return torch.from_numpy(np.array(p))


def _close(got, want, rel=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * top, f"max |diff| {err} > {rel} x {top}"


def _tokens(cfg, B, S_, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S_)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw in CUTS.items():
        rcfg, cfg = _cfgs(**kw)
        tree = jax.tree.map(np.asarray, RM.init_params(
            rcfg, jax.random.PRNGKey(0)))
        out[name] = (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
                     M.params_from_numpy(cfg, tree, device="cpu"))
    return out


@pytest.fixture(scope="module")
def blocks():
    """One MLA block's parameters at each cut: the reference's
    ``init_mla`` as numpy, and the port's tensors."""
    out = {}
    for name, kw in CUTS.items():
        rcfg, cfg = _cfgs(**kw)
        p = jax.tree.map(np.asarray, RA.init_mla(
            rcfg, jax.random.PRNGKey(1), jnp.float32))
        out[name] = (rcfg, jax.tree.map(jnp.asarray, p), cfg,
                     _torch_tree(p))
    return out


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_copies_the_published_numbers():
    """Every field the port keeps holds the reference's value, in the
    published config and in ``reduced()``; the family and the config are
    ported."""
    def kept(cfg):
        return {f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(base.ModelConfig)}

    rc, c = ref_base.get_config(ARCH), base.get_config(ARCH)
    assert kept(c) == {k: getattr(rc, k) for k in kept(c)}
    assert kept(c.reduced()) == {k: getattr(rc.reduced(), k)
                                 for k in kept(c)}
    assert (c.family, c.padded_vocab, c.num_layers) == ("mla_moe", 129280,
                                                        61)
    assert "deepseek_v3_671b" in base.PORTED_CONFIGS
    assert "mla_moe" in base.PORTED_FAMILIES
    assert base.get_config("deepseek-v3-671b").family == "mla_moe"


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("published", [False, True])
def test_init_mla_shapes_match_the_reference(published):
    """The reduced config's block and, on the meta device, the published
    one (q_lora 1536, kv_lora 512, 128 heads of 128 + 64, v 128): keys,
    shapes and dtypes, norms in float32."""
    rcfg, cfg = (ref_base.get_config(ARCH), base.get_config(ARCH)) \
        if published else _cfgs()
    want = jax.eval_shape(lambda k: RA.init_mla(rcfg, k, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    got = A.init_mla(cfg, torch.Generator(), torch.bfloat16,
                     "meta" if published else "cpu")
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
    if published:
        assert tuple(got["wq_b"].shape) == (1536, 128 * 192)
        assert tuple(got["w_v"].shape) == (512, 128, 128)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("cut", list(CUTS))
def test_mla_forward_and_its_cache_match_the_reference(cut, window, blocks):
    rcfg, rp, cfg, p = blocks[cut]
    x = np.random.default_rng(0).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24))
    out, (c_n, kr) = A.mla_forward(cfg, p, torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()),
                                   window=window, return_cache=True)
    rout, (rc_n, rkr) = RA.mla_forward(rcfg, rp, jnp.asarray(x),
                                       jnp.asarray(pos), window=window,
                                       return_cache=True)
    _close(out, rout)
    _close(c_n, rc_n)
    _close(kr, rkr)
    assert tuple(kr.shape) == (2, 24, cfg.qk_rope_head_dim)
    _close(A.mla_forward(cfg, p, torch.from_numpy(x),
                         torch.from_numpy(pos.copy()), window=window), rout)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("cut", list(CUTS))
def test_mla_decode_matches_the_reference(cut, window, blocks):
    """Three absorbed decode steps into a latent cache of 12 slots (a
    ring of 8 with a window, wrapped), the cache written in place."""
    rcfg, rp, cfg, p = blocks[cut]
    rng = np.random.default_rng(1)
    C = window or 12
    cc = rng.standard_normal((2, C, cfg.kv_lora_rank)).astype(np.float32)
    ckr = rng.standard_normal((2, C, cfg.qk_rope_head_dim)).astype(
        np.float32)
    tc, tkr = torch.from_numpy(cc.copy()), torch.from_numpy(ckr.copy())
    rc, rkr = jnp.asarray(cc), jnp.asarray(ckr)
    for pos in (5, 9, 10):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        out, tc2, tkr2 = A.mla_decode(cfg, p, torch.from_numpy(x), tc, tkr,
                                      pos, window=window)
        assert tc2 is tc and tkr2 is tkr
        rout, rc, rkr = RA.mla_decode(rcfg, rp, jnp.asarray(x), rc, rkr,
                                      jnp.asarray(pos, jnp.int32),
                                      window=window)
        _close(out, rout)
        _close(tc, rc)
        _close(tkr, rkr)


def test_mla_decode_raises_past_a_full_cache(blocks):
    _, _, cfg, p = blocks["reduced"]
    cc = torch.zeros(1, 4, cfg.kv_lora_rank)
    ckr = torch.zeros(1, 4, cfg.qk_rope_head_dim)
    x = torch.zeros(1, 1, cfg.d_model)
    with pytest.raises(IndexError, match="position 4 outside a cache of 4"):
        A.mla_decode(cfg, p, x, cc, ckr, 4)
    # a ring takes any position
    A.mla_decode(cfg, p, x, cc, ckr, 4, window=4)


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cut", list(CUTS))
def test_forward_matches_the_reference(cut, models):
    rcfg, rparams, cfg, params = models[cut]
    assert M.param_count(params) == RM.param_count(rparams)
    assert set(params) == {"embed", "ln_f", "dense_layers", "moe_layers"}
    assert (len(params["dense_layers"]), len(params["moe_layers"])) == (1, 1)
    assert set(params["dense_layers"][0]) == {"attn", "mlp", "ln1", "ln2"}
    assert set(params["moe_layers"][0]) == {"attn", "moe", "ln1", "ln2"}
    tok = _tokens(cfg, 2, 24)
    got = M.forward(cfg, params, {"tokens": torch.from_numpy(tok)})
    want = RM.forward(rcfg, rparams, {"tokens": jnp.asarray(tok)})
    assert got.shape == (2, 24, cfg.padded_vocab)
    _close(got, want)


@pytest.mark.parametrize("cut", list(CUTS))
def test_prefill_cache_and_decode_match_the_reference(cut, models):
    """prefill's last logits and its latent cache, both stacks, then
    three decode steps in the cache grown by three positions."""
    rcfg, rparams, cfg, params = models[cut]
    tok = _tokens(cfg, 2, 24, seed=1)
    lg, cache = M.prefill(cfg, params, {"tokens": torch.from_numpy(tok)})
    rlg, rcache = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(tok)})
    _close(lg, rlg)
    assert set(cache) == set(rcache) == {"dense", "moe"}
    for stack in ("dense", "moe"):
        assert set(cache[stack]) == set(rcache[stack]) == {"c", "kr"}
        for k in ("c", "kr"):
            _close(cache[stack][k], rcache[stack][k])
    assert tuple(cache["moe"]["c"].shape) == (1, 2, 24, cfg.kv_lora_rank)
    cache = {s: {k: torch.cat([c, torch.zeros_like(c[:, :, :3])], 2)
                 for k, c in part.items()} for s, part in cache.items()}
    rcache = {s: {k: jnp.concatenate([c, 0 * c[:, :, :3]], 2)
                  for k, c in part.items()} for s, part in rcache.items()}
    nxt = _tokens(cfg, 2, 3, seed=2)
    for i in range(3):
        lg, cache = M.decode_step(cfg, params, cache, {
            "token": torch.from_numpy(nxt[:, i:i + 1]), "pos": 24 + i})
        rlg, rcache = RM.decode_step(rcfg, rparams, rcache, {
            "token": jnp.asarray(nxt[:, i:i + 1]),
            "pos": jnp.asarray(24 + i, jnp.int32)})
        _close(lg, rlg)
    for stack in ("dense", "moe"):
        for k in ("c", "kr"):
            _close(cache[stack][k], rcache[stack][k])


@pytest.mark.parametrize("cut", list(CUTS))
def test_prefill_equals_the_decode_only_loop(cut, models):
    """The decompressed prefill and the absorbed decode compute one
    function: the launcher's decode-only loop lands on prefill's last
    logits within 1e-4 of the largest."""
    _, _, cfg, params = models[cut]
    tok = torch.from_numpy(_tokens(cfg, 2, 16, seed=5))
    lg, _ = M.prefill(cfg, params, {"tokens": tok})
    g = prefill_gap.gap(lg, prefill_gap.decode_loop(cfg, params, tok))
    assert g["max_abs_rel"] <= 1e-4 and g["argmax_agree"] == 1.0


def test_decode_step_raises_past_a_full_latent_cache(models):
    _, _, cfg, params = models["reduced"]
    cache = M.init_cache(cfg, 1, 4, device="cpu")
    assert {s: tuple(c["kr"].shape) for s, c in cache.items()} == {
        "dense": (1, 1, 4, 16), "moe": (1, 1, 4, 16)}
    tok = torch.zeros((1, 1), dtype=torch.long)
    M.decode_step(cfg, params, cache, {"token": tok, "pos": 3})
    with pytest.raises(IndexError, match="position 4 outside a cache of 4"):
        M.decode_step(cfg, params, cache, {"token": tok, "pos": 4})


@pytest.mark.parametrize("n,dense", [(1, 0), (2, 1), (4, 3), (5, 3),
                                     (61, 3)])
def test_prefill_gap_layers_keeps_a_moe_layer(n, dense):
    """``--layers n`` on DeepSeek-V3 keeps min(3, n - 1) dense layers;
    the cut's params hold that many of each stack (on the meta
    device)."""
    cfg = prefill_gap.cut_layers(base.get_config(ARCH), n)
    assert (cfg.num_layers, cfg.first_dense_layers) == (n, dense)
    params = M.init_params(cfg, torch.Generator(), device="meta")
    assert (len(params["dense_layers"]), len(params["moe_layers"])) == (
        dense, n - dense)


def test_prefill_gap_runs_the_family_and_its_control():
    flags = ["--arch", ARCH, "--reduced", "--layers", "2", "--batch", "2",
             "--prompt-len", "16", "--capacity-factor", "8.0", "--device",
             "cpu"]
    res = prefill_gap.run(flags)
    assert (res["layers"], res["capacity_factor"]) == (2, 8.0)
    assert res["max_abs_rel"] <= 1e-4
    flip = prefill_gap.run(flags + ["--flip", "12"])
    assert flip["max_abs_rel"] >= 100 * max(res["max_abs_rel"], 1e-7)


def test_family_refuses_more_dense_layers_than_layers():
    cfg = base.get_config(ARCH).reduced().replace(first_dense_layers=3)
    with pytest.raises(ValueError, match="first_dense_layers 3 outside"):
        M.init_params(cfg, torch.Generator(), device="meta")


# ---------------------------------------------------------------------------
# K7 at MLA's widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("hd,hd_v", [(192, 128), (48, 32)])
def test_attention_at_mla_widths_matches_the_reference(hd, hd_v, window):
    """``flash_attention_plain`` (K7's oracle) and ``layers.attention``
    against the reference's ``L.attention`` with v narrower than q and
    k, 4 heads over 2 kv heads, causal."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 96, 4, hd)).astype(np.float32)
    k = rng.standard_normal((2, 96, 2, hd)).astype(np.float32)
    v = rng.standard_normal((2, 96, 2, hd_v)).astype(np.float32)
    want = RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, q_offset=0, window=window)
    assert want.shape == (2, 96, 4, hd_v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fa.flash_attention_plain(tq.transpose(1, 2), tk.transpose(1, 2),
                                   tv.transpose(1, 2), window=window)
    _close(got.transpose(1, 2), want)
    _close(L.attention(tq, tk, tv, causal=True, q_offset=0, window=window,
                       q_chunk=32), want)


def _views(B, S, H, hd, dtype):
    """A (B, S, H, hd) tensor as the (B, H, S, hd) view the model
    passes."""
    return torch.zeros((B, S, H, hd), dtype=dtype).transpose(1, 2)


def _plan(hd, hd_v, dtype, H=128):
    q, k = _views(8, 1024, H, hd, dtype), _views(8, 1024, H, hd, dtype)
    v, out = _views(8, 1024, H, hd_v, dtype), _views(8, 1024, H, hd_v, dtype)
    return fa.launch_plan(q, k, v, out)


@pytest.mark.parametrize("dtype,smem,block_k", [
    (torch.bfloat16, 214_072, 128), (torch.float32, 197_656, 32)])
def test_launch_plan_at_mla_widths(dtype, smem, block_k):
    """(192, 128) on both routes: K counted at 192 and V at 128 (at 192
    both, bf16 would ask 246 840 bytes, over a block's 232 448), one
    float32 block an SM."""
    plan = _plan(192, 128, dtype)
    assert (plan["tile_width"], plan["tile_width_v"]) == (192, 128)
    assert (plan["smem_bytes"], plan["block_k"]) == (smem, block_k)
    assert plan["smem_bytes"] <= fa.SMEM_PER_BLOCK
    if dtype == torch.bfloat16:
        assert (plan["route"], plan["swizzle"], plan["stages"]) == (
            "wgmma", 128, 2)
        assert 1024 + 128 * 192 * 2 + 4 * 128 * 192 * 2 + 56 > \
            fa.SMEM_PER_BLOCK
    else:
        assert (plan["route"], plan["blocks_per_sm"]) == ("wgmma_tf32", 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_launch_plan_at_equal_widths_is_unchanged(hd, dtype):
    """Every equal pair keeps the plan one width gave: K and V tiles at
    the tile width, the same key tile and shared memory."""
    plan = _plan(hd, hd, dtype, H=8)
    tile = fa.TILE_WIDTH.get(hd, hd)
    assert plan["tile_width"] == plan["tile_width_v"] == tile
    if dtype == torch.bfloat16:
        bk = 128 if hd <= 128 else 64
        assert (plan["block_k"], plan["smem_bytes"]) == (
            bk, 1024 + 128 * tile * 2 + 2 * 2 * bk * tile * 2 + 8 * 7)
    else:
        bk = 32 if hd <= 128 else 16
        assert (plan["block_k"], plan["smem_bytes"]) == (
            bk, 1024 + 2 * 64 * tile * 4 + 5 * bk * tile * 4 + 24)


@pytest.mark.parametrize("hd,hd_v", [(192, 96), (128, 64), (48, 32),
                                     (256, 128), (128, 192)])
def test_launch_plan_refuses_other_width_pairs(hd, hd_v):
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match=f"q/k width {hd} with v width "
                                             f"{hd_v}"):
            _plan(hd, hd_v, dtype, H=4)


def test_prefill_reaches_k7_once_a_layer_at_192_and_128(models,
                                                        monkeypatch):
    """The card's dispatch, rehearsed on the CPU: with ``pick`` choosing
    the kernel wrapper (stood in for by the plain version, planning its
    launch), a prefill at DeepSeek-V3's head widths calls K7 once per
    layer at (192, 128) and a decode step never (its attention is the
    absorbed einsums, as in the reference); the logits are the plain
    path's.  At the reduced widths (48, 32) the plan raises, as the
    kernel would."""
    _, _, cfg, params = models["published_heads"]
    tok = torch.from_numpy(_tokens(cfg, 2, 16, seed=6))
    want, _ = M.prefill(cfg, params, {"tokens": tok})
    plans = []

    def k7(q, k, v, **kw):
        out = fa.flash_attention_plain(q, k, v, **kw)
        plans.append(fa.launch_plan(q, k, v, out))
        return out

    monkeypatch.setattr(segment_sum, "pick", lambda card, plain, t: card)
    monkeypatch.setattr(fa, "flash_attention_cuda", k7)
    got, cache = M.prefill(cfg, params, {"tokens": tok})
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert [(p["tile_width"], p["tile_width_v"]) for p in plans] == \
        [(192, 128)] * cfg.num_layers
    cache = {s: {k: torch.cat([c, torch.zeros_like(c[:, :, :1])], 2)
                 for k, c in part.items()} for s, part in cache.items()}
    M.decode_step(cfg, params, cache, {"token": tok[:, :1], "pos": 16})
    assert len(plans) == cfg.num_layers
    _, _, small, small_params = models["reduced"]
    with pytest.raises(ValueError, match="q/k width 48 with v width 32"):
        M.prefill(small, small_params, {"tokens": tok})
