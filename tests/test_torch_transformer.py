"""The port's transformer serving path (``repro_torch.models.transformer``,
``repro_torch.launch.serve``) against the reference's JAX functions, on
identical numpy inputs and parameters, at the reduced configs in float32.

On the CPU the port runs the plain versions of K7 and K8; the kernels
are held against those on the card by ``chip_smoke.py``.  Tolerances:
2e-5 (rtol and atol) for single layers, 1e-4 for the two-layer models'
logits (float32 sums in another order, through two layers, the final
norm and the unembedding).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models.transformer import attention as RA
from repro.models.transformer import layers as RL
from repro.models.transformer import model as RM
from repro.models.transformer import ssm as RS
from repro_torch.configs import base
from repro_torch.kernels import ops
from repro_torch.launch import prefill_gap, serve
from repro_torch.models.transformer import attention as A
from repro_torch.models.transformer import layers as L
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer import ssm as S

TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("phi3-mini-3.8b", "mamba2-780m", "qwen2.5-14b", "gemma-7b",
         "glm4-9b", "zamba2-2.7b", "granite-moe-1b-a400m")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfgs(arch, **kw):
    return (ref_base.get_config(arch).reduced().replace(**kw),
            base.get_config(arch).reduced().replace(**kw))


def _ref_params_np(cfg):
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_the_published_numbers(arch):
    """Every field the port keeps holds the reference's value, in the
    published config and in its reduced() cut; the port keeps no field
    the reference lacks."""
    def kept(cfg):
        return {f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(base.ModelConfig)}

    ref_fields = {f.name for f in dataclasses.fields(ref_base.ModelConfig)}
    assert set(kept(base.get_config(arch))) <= ref_fields
    assert kept(base.get_config(arch)) == kept(ref_base.get_config(arch))
    r = base.get_config(arch)
    assert kept(r.reduced()) == kept(ref_base.get_config(arch).reduced())
    for prop in ("resolved_head_dim", "padded_vocab", "d_inner",
                 "ssm_nheads"):
        assert getattr(r, prop) == getattr(ref_base.get_config(arch), prop)
    assert base.INPUT_SHAPES == {k: base.ShapeConfig(*dataclasses.astuple(v))
                                 for k, v in ref_base.INPUT_SHAPES.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    x, s, b = _rand(rng, 3, 5, 64), _rand(rng, 64), _rand(rng, 64)
    np.testing.assert_allclose(
        _np(L.rmsnorm(_t(x), _t(s))), _np(RL.rmsnorm(x, s)), **TOL)
    np.testing.assert_allclose(
        _np(L.layernorm(_t(x), _t(s), _t(b))),
        _np(RL.layernorm(x, s, b)), **TOL)


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_apply_rope_standard_and_partial(frac):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    got = L.apply_rope(_t(x), _t(pos), 10_000.0, frac)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, frac)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    if frac < 1:            # the unrotated half passes through untouched
        np.testing.assert_array_equal(_np(got)[..., 16:], x[..., 16:])


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("silu", False)])
def test_mlp(act, gated):
    rcfg, cfg = _cfgs("phi3-mini-3.8b", act=act, mlp_gated=gated)
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 5, cfg.d_model)
    p = {"w_in": _rand(rng, cfg.d_model, 96) * 0.1,
         "w_out": _rand(rng, 96, cfg.d_model) * 0.1}
    if gated:
        p["w_gate"] = _rand(rng, cfg.d_model, 96) * 0.1
    got = L.mlp(cfg, _t(x), {k: _t(v) for k, v in p.items()})
    want = RL.mlp(rcfg, jnp.asarray(x), p)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("q_chunk", [16, 1024])
def test_attention_chunked_queries(window, q_chunk):
    """Sq 40 over query chunks of 16 (the last one ragged) and in one
    block; GQA with G = 3."""
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 40, 6, 16), _rand(rng, 2, 40, 2, 16), \
        _rand(rng, 2, 40, 2, 16)
    got = L.attention(_t(q), _t(k), _t(v), causal=True, q_offset=0,
                      window=window, q_chunk=q_chunk)
    want = RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, q_offset=0, window=window,
                        q_chunk=q_chunk)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_attention_offset_and_valid_len_on_cpu():
    """The plain path keeps the reference's q_offset and kv_valid_len (the
    card raises for them; chip_smoke.py checks that there)."""
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 1, 4, 2, 8), _rand(rng, 1, 12, 2, 8), \
        _rand(rng, 1, 12, 2, 8)
    got = L.attention(_t(q), _t(k), _t(v), causal=True, q_offset=5,
                      kv_valid_len=9)
    want = RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, q_offset=5, kv_valid_len=9)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_attention_refuses_devices_without_a_kernel():
    """Only the CPU runs the plain version (the card's refusals of ragged
    or unaligned calls are checked on the card by chip_smoke.py)."""
    q = torch.zeros(1, 4, 2, 64, device="meta")
    k = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        L.attention(q, k, k, causal=True, q_offset=4)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def _gqa_params(cfg, rng):
    hd, D = cfg.resolved_head_dim, cfg.d_model
    s = np.float32(1 / np.sqrt(D))
    return {"wq": _rand(rng, D, cfg.num_heads * hd) * s,
            "wk": _rand(rng, D, cfg.num_kv_heads * hd) * s,
            "wv": _rand(rng, D, cfg.num_kv_heads * hd) * s,
            "wo": _rand(rng, cfg.num_heads * hd, D) * s,
            "bq": _rand(rng, cfg.num_heads * hd),
            "bk": _rand(rng, cfg.num_kv_heads * hd),
            "bv": _rand(rng, cfg.num_kv_heads * hd)}


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("window", [0, 5])
def test_gqa_forward(qkv_bias, window):
    rcfg, cfg = _cfgs("phi3-mini-3.8b", qkv_bias=qkv_bias)
    rng = np.random.default_rng(5)
    p = _gqa_params(cfg, rng)
    x = _rand(rng, 2, 12, cfg.d_model)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).astype(np.int32)
    got, (k, v) = A.gqa_forward(cfg, {k: _t(w) for k, w in p.items()},
                                _t(x), _t(pos), window=window,
                                return_kv=True)
    want, (rk, rv) = RA.gqa_forward(rcfg, p, jnp.asarray(x),
                                    jnp.asarray(pos), window=window,
                                    return_kv=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(k), _np(rk), **TOL)
    np.testing.assert_allclose(_np(v), _np(rv), **TOL)


@pytest.mark.parametrize("window", [0, 4])
def test_gqa_decode_full_and_ring_cache(window):
    """Eleven decode steps: with a window of 4 the ring wraps twice."""
    rcfg, cfg = _cfgs("phi3-mini-3.8b")
    rng = np.random.default_rng(6)
    p = _gqa_params(cfg, rng)
    pt = {k: _t(w) for k, w in p.items()}
    C = window or 11
    shape = (2, C, cfg.num_kv_heads, cfg.resolved_head_dim)
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    rk, rv = jnp.zeros(shape), jnp.zeros(shape)
    for pos in range(11):
        x = _rand(rng, 2, 1, cfg.d_model)
        got, ck, cv = A.gqa_decode(cfg, pt, _t(x), ck, cv, pos,
                                   window=window)
        want, rk, rv = RA.gqa_decode(rcfg, p, jnp.asarray(x), rk, rv,
                                     jnp.asarray(pos, jnp.int32),
                                     window=window)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(_np(ck), _np(rk), **TOL)
        np.testing.assert_allclose(_np(cv), _np(rv), **TOL)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, B, S_, H, P, G, N):
    return (_rand(rng, B, S_, H, P),
            rng.random((B, S_, H)).astype(np.float32) * 0.5,
            -(rng.random(H).astype(np.float32) + 0.2),
            _rand(rng, B, S_, G, N), _rand(rng, B, S_, G, N))


@pytest.mark.parametrize("S_,chunk,G", [(32, 8, 1), (24, 8, 2), (6, 16, 1)])
def test_ssd_chunked_with_final_state(S_, chunk, G):
    rng = np.random.default_rng(7)
    x, dt, A_, Bm, Cm = _ssd_inputs(rng, 2, S_, 4, 8, G, 16)
    y, fin = S.ssd_chunked(*map(_t, (x, dt, A_, Bm, Cm)), chunk,
                           return_final_state=True)
    ry, rfin = RS.ssd_chunked(*map(jnp.asarray, (x, dt, A_, Bm, Cm)), chunk,
                              return_final_state=True)
    np.testing.assert_allclose(_np(y), _np(ry), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(fin), _np(rfin), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S_", [20, 9])
def test_ssd_chunked_length_check_raises_value_error(S_):
    """The reference asserts S % chunk == 0 (stripped under -O); the port
    raises ValueError naming the length and the chunk."""
    rng = np.random.default_rng(8)
    x, dt, A_, Bm, Cm = _ssd_inputs(rng, 1, S_, 2, 4, 1, 8)
    with pytest.raises(ValueError, match=f"length {S_} .* chunk 8"):
        S.ssd_chunked(*map(_t, (x, dt, A_, Bm, Cm)), 8)


def _ssm_layer_np(cfg, seed):
    p = RS.init_ssm(cfg, jax.random.PRNGKey(seed), jnp.float32)
    p = jax.tree.map(np.asarray, p)
    # non-trivial dt_bias, D and conv bias, so every term is exercised
    rng = np.random.default_rng(seed)
    p["dt_bias"] = rng.standard_normal(p["dt_bias"].shape).astype(np.float32)
    p["D"] = rng.standard_normal(p["D"].shape).astype(np.float32)
    p["conv_b"] = rng.standard_normal(p["conv_b"].shape).astype(np.float32)
    return p


def test_ssm_forward_and_decode_continue_each_other():
    """ssm_forward's cache, then four ssm_decode steps, against the
    reference's at every step."""
    rcfg, cfg = _cfgs("mamba2-780m")
    p = _ssm_layer_np(rcfg, 9)
    pt = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(9)
    x = _rand(rng, 2, 32, cfg.d_model)
    got, (st, cv) = S.ssm_forward(cfg, pt, _t(x), return_cache=True)
    want, (rst, rcv) = RS.ssm_forward(rcfg, p, jnp.asarray(x),
                                      return_cache=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(st), _np(rst), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(cv), _np(rcv), **TOL)
    np.testing.assert_allclose(_np(S.ssm_forward(cfg, pt, _t(x))),
                               _np(got), **TOL)
    for _ in range(4):
        xt = _rand(rng, 2, 1, cfg.d_model)
        got, st, cv = S.ssm_decode(cfg, pt, _t(xt), st, cv)
        want, rst, rcv = RS.ssm_decode(rcfg, p, jnp.asarray(xt), rst, rcv)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(_np(st), _np(rst), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# whole models through params_from_numpy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """For each reduced arch: the reference's config and params, the
    port's config and params converted from them."""
    out = {}
    for arch in ARCHS:
        rcfg, cfg = _cfgs(arch)
        tree = _ref_params_np(rcfg)
        out[arch] = (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
                     M.params_from_numpy(cfg, tree, device="cpu"))
    return out


def _tokens(cfg, B, S_, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S_)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_and_param_count(arch, models):
    rcfg, rparams, cfg, params = models[arch]
    assert M.param_count(params) == RM.param_count(rparams)
    own = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert M.param_count(own) == M.param_count(params)
    np.testing.assert_array_equal(
        _np(params["layers"][1]["ln1" if cfg.family in ("dense", "moe")
                                else "ln"]
            ["scale"]), np.ones(cfg.d_model, np.float32))
    bad = jax.tree.map(np.asarray, rparams)
    bad["ln_f"] = {"weight": bad["ln_f"]["scale"]}
    with pytest.raises(ValueError, match="keys"):
        M.params_from_numpy(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, models):
    rcfg, rparams, cfg, params = models[arch]
    tok = _tokens(cfg, 2, 32)
    got = M.forward(cfg, params, {"tokens": _t(tok)})
    want = RM.forward(rcfg, rparams, {"tokens": jnp.asarray(tok)})
    assert got.shape == (2, 32, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)


def _with_room(cache, n, cat=torch.cat):
    """prefill's cache (the prompt's positions, as the reference's) with
    ``n`` zero slots more for the decode steps that follow, in its K/V
    part (the hybrid's ``attn``); an SSM cache holds no positions.
    ``cat=jnp.concatenate`` grows the reference's."""
    if "k" not in cache:
        return {k: _with_room(c, n, cat) if isinstance(c, dict) else c
                for k, c in cache.items()}
    return {k: cat([c, 0 * c[:, :, :n]], 2) for k, c in cache.items()}


def _cache_leaves(cache, path=""):
    """(path, array) of every leaf of a (nested) cache, in key order."""
    for k in sorted(cache):
        if isinstance(cache[k], dict):
            yield from _cache_leaves(cache[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", cache[k]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_steps_match_reference(arch, models):
    """prefill's last logits and cache, then four decode_steps continuing
    in that cache, against the reference at every step."""
    rcfg, rparams, cfg, params = models[arch]
    tok = _tokens(cfg, 2, 32, seed=1)
    lg, cache = M.prefill(cfg, params, {"tokens": _t(tok)})
    rlg, rcache = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(_np(lg), _np(rlg), **MODEL_TOL)
    got, want = list(_cache_leaves(cache)), list(_cache_leaves(rcache))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, c), (_, rc) in zip(got, want):
        assert tuple(c.shape) == tuple(rc.shape)
        np.testing.assert_allclose(_np(c), _np(rc), **MODEL_TOL)
    # grow both caches to hold four more positions
    cache = _with_room(cache, 4)
    rcache = _with_room(rcache, 4, jnp.concatenate)
    nxt = _tokens(cfg, 2, 4, seed=2)
    for i in range(4):
        lg, cache = M.decode_step(cfg, params, cache,
                                  {"token": _t(nxt[:, i:i + 1]),
                                   "pos": 32 + i})
        rlg, rcache = RM.decode_step(rcfg, rparams, rcache,
                                     {"token": jnp.asarray(nxt[:, i:i + 1]),
                                      "pos": jnp.asarray(32 + i, jnp.int32)})
        np.testing.assert_allclose(_np(lg), _np(rlg), **MODEL_TOL)


def test_sliding_window_prefill_ring_matches_reference():
    """Phi-3 with a sliding window of 8 over a 20-token prompt: the ring
    cache layout (position p in slot p % 8) and the logits, then decode
    steps that keep wrapping the ring."""
    rcfg, cfg = _cfgs("phi3-mini-3.8b", sliding_window=8)
    tree = _ref_params_np(rcfg)
    rparams = jax.tree.map(jnp.asarray, tree)
    params = M.params_from_numpy(cfg, tree, device="cpu")
    tok = _tokens(cfg, 2, 20, seed=3)
    lg, cache = M.prefill(cfg, params, {"tokens": _t(tok)})
    rlg, rcache = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(_np(lg), _np(rlg), **MODEL_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache[k]), _np(rcache[k]),
                                   **MODEL_TOL)
    for i in range(10):
        t = tok[:, i:i + 1]
        lg, cache = M.decode_step(cfg, params, cache,
                                  {"token": _t(t), "pos": 20 + i})
        rlg, rcache = RM.decode_step(rcfg, rparams, rcache,
                                     {"token": jnp.asarray(t),
                                      "pos": jnp.asarray(20 + i, jnp.int32)})
        np.testing.assert_allclose(_np(lg), _np(rlg), **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_round_trip(arch, models):
    """prefill, its cache grown by GEN slots, then iterated decode_step,
    reproduces forward()'s argmax chain (the reference's
    tests/test_system.py::test_greedy_decode_roundtrip, on the port)."""
    _, _, cfg, params = models[arch]
    # every length stays within one SSD chunk of 16, as forward needs
    B, S_, GEN = 2, 12, 4
    seq = _t(_tokens(cfg, B, S_, seed=4)).long()
    for _ in range(GEN):
        lg = M.forward(cfg, params, {"tokens": seq})
        nxt = torch.argmax(lg[:, -1, :cfg.vocab_size], -1)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
    lg, cache = M.prefill(cfg, params, {"tokens": seq[:, :S_]})
    cache = _with_room(cache, GEN)
    out = [torch.argmax(lg[:, :cfg.vocab_size], -1)]
    for t in range(S_, S_ + GEN - 1):
        lg, cache = M.decode_step(cfg, params, cache,
                                  {"token": seq[:, t:t + 1], "pos": t})
        out.append(torch.argmax(lg[:, :cfg.vocab_size], -1))
    for i in range(GEN):
        torch.testing.assert_close(out[i], seq[:, S_ + i])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_equal_decode_only_loop(arch, models):
    """The serving loop feeds the prompt through decode_step; its logits
    at the last prompt position agree with prefill's."""
    _, _, cfg, params = models[arch]
    tok = _t(_tokens(cfg, 2, 16, seed=5))
    lg, _ = M.prefill(cfg, params, {"tokens": tok})
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    for t in range(16):
        dl, cache = M.decode_step(cfg, params, cache,
                                  {"token": tok[:, t:t + 1], "pos": t})
    np.testing.assert_allclose(_np(dl), _np(lg), **MODEL_TOL)


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch, capsys):
    ops.reset_launch_counts()
    toks = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "16", "--gen", "5", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert toks.shape == (2, 5)
    assert ((0 <= toks) & (toks < 512)).all()
    assert "prefill:" in out and "decode:" in out and "tok/s" in out
    # the decode-only loop never runs the kernels' paths
    assert not any(ops.launch_counts().values())
    again = serve.run(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "16", "--gen", "5", "--device",
                       "cpu"])
    np.testing.assert_array_equal(again["tokens"], toks)
    assert np.isfinite(_np(again["logits"])).all()


def test_serve_refusals():
    with pytest.raises(SystemExit, match="whisper_vlm_smoke"):
        serve.main(["--arch", "whisper-tiny", "--device", "cpu"])
    with pytest.raises(SystemExit, match="whisper_vlm_smoke"):
        serve.main(["--arch", "qwen2-vl-7b", "--device", "cpu"])


def test_serve_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2-780m", "--reduced", "--batch", "1",
                    "--prompt-len", "4", "--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2-780m", "--reduced", "--device",
                    "cuda"])


# ---------------------------------------------------------------------------
# prefill against the decode-only loop (repro_torch.launch.prefill_gap)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_gap_is_roundoff_and_its_control_is_not(arch, capsys):
    """On the same prompt (two SSD chunks for Mamba2) the two paths agree
    to float32 roundoff; a prompt that differs in one token halfway
    (``--flip``) moves the last logits far more."""
    flags = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
             "32", "--device", "cpu"]
    same = prefill_gap.main(flags)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]
                      )["max_abs"] == same["max_abs"]
    assert same["dtype"] == "float32" and same["prompt_len"] == 32
    assert same["max_abs_rel"] <= 1e-5 and same["argmax_agree"] == 1.0
    flip = prefill_gap.run(flags + ["--flip", "16"])
    assert flip["max_abs_rel"] >= 100 * max(same["max_abs_rel"], 1e-7)
    with pytest.raises(ValueError, match="--flip"):
        prefill_gap.run(flags + ["--flip", "32"])


def test_prefill_gap_helpers_match_the_model(models):
    """decode_loop is the launcher's loop (its last logits equal a manual
    decode over a fresh cache); gap's ratios follow their definitions."""
    _, _, cfg, params = models["phi3-mini-3.8b"]
    tok = _t(_tokens(cfg, 2, 6, seed=7))
    cache = M.init_cache(cfg, 2, 6, device="cpu")
    for t in range(6):
        want, cache = M.decode_step(cfg, params, cache,
                                    {"token": tok[:, t:t + 1], "pos": t})
    torch.testing.assert_close(prefill_gap.decode_loop(cfg, params, tok),
                               want, rtol=0, atol=0)
    a = torch.tensor([[1.0, 3.0], [2.0, 0.0]])
    b = torch.tensor([[1.0, 2.0], [0.0, 4.0]])
    g = prefill_gap.gap(a, b)
    assert g["max_abs"] == 4.0 and g["max_abs_ref"] == 4.0
    assert g["max_abs_rel"] == 1.0 and g["argmax_agree"] == 0.5
    assert g["rms_ratio"] == pytest.approx(1.0)      # sqrt(21) / sqrt(21)


def test_prefill_gap_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        prefill_gap.run(["--arch", "mamba2-780m", "--reduced"])
