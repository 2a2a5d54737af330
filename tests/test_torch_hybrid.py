"""The port's ``hybrid`` family (Zamba2-2.7B: groups of ``attn_every``
Mamba2 layers, each followed by one shared dense block) against the
reference's JAX functions, on identical numpy inputs and parameters, at
small float32 cuts of the config with the published head width of 80,
so that the shared block's attention reaches K7's plain version at hd
80.  The reference computes attention and the SSD chunk state in XLA, so
no Pallas interpret mode is needed.  Tolerance: 1e-4 (rtol and atol), as
``tests/test_torch_transformer.py`` holds the other families' models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models.transformer import model as RM
from repro_torch.configs import base
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import segment_sum
from repro_torch.kernels import ssd_chunk as ssd
from repro_torch.launch import prefill_gap
from repro_torch.models.transformer import model as M

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# (num_layers, attn_every): two and three applications of the shared block
CUTS = ((4, 2), (6, 3))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(num_layers, attn_every):
    kw = dict(num_layers=num_layers, attn_every=attn_every, head_dim=80)
    return (ref_base.get_config("zamba2-2.7b").reduced().replace(**kw),
            base.get_config("zamba2-2.7b").reduced().replace(**kw))


@pytest.fixture(scope="module")
def models():
    out = {}
    for cut in CUTS:
        rcfg, cfg = _cfgs(*cut)
        tree = jax.tree.map(np.asarray,
                            RM.init_params(rcfg, jax.random.PRNGKey(0)))
        out[cut] = (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
                    M.params_from_numpy(cfg, tree, device="cpu"), tree)
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(cfg, B, S_, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S_)).astype(np.int32)


@pytest.mark.parametrize("cut", CUTS)
def test_hybrid_forward_matches_reference(cut, models):
    rcfg, rparams, cfg, params, _ = models[cut]
    assert cfg.resolved_head_dim == 80 and M.param_count(params) == \
        RM.param_count(rparams)
    tok = _tokens(cfg, 2, 32)
    got = M.forward(cfg, params, {"tokens": torch.from_numpy(tok)})
    want = RM.forward(rcfg, rparams, {"tokens": jnp.asarray(tok)})
    assert got.shape == (2, 32, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)


@pytest.mark.parametrize("cut", CUTS)
def test_hybrid_prefill_caches_and_decode_match_reference(cut, models):
    """prefill's last logits, its SSM cache (every layer's state and conv
    window) and its grouped K/V cache (one slot a group), then three
    decode_steps in both caches grown by three positions."""
    rcfg, rparams, cfg, params, _ = models[cut]
    n_groups = cfg.num_layers // cfg.attn_every
    tok = _tokens(cfg, 2, 32, seed=1)
    lg, cache = M.prefill(cfg, params, {"tokens": torch.from_numpy(tok)})
    rlg, rcache = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(_np(lg), _np(rlg), **MODEL_TOL)
    assert set(cache) == {"ssm", "attn"}
    for part, keys in (("ssm", ("state", "conv")), ("attn", ("k", "v"))):
        assert set(cache[part]) == set(rcache[part]) == set(keys)
        for k in keys:
            assert tuple(cache[part][k].shape) == tuple(rcache[part][k].shape)
            np.testing.assert_allclose(_np(cache[part][k]),
                                       _np(rcache[part][k]), **MODEL_TOL)
    assert cache["attn"]["k"].shape == (n_groups, 2, 32, 2, 80)
    assert cache["ssm"]["state"].shape[0] == cfg.num_layers
    room = {k: torch.cat([c, c.new_zeros(c.shape[:2] + (3,) + c.shape[3:])],
                         dim=2) for k, c in cache["attn"].items()}
    cache = {"ssm": cache["ssm"], "attn": room}
    rcache = {"ssm": rcache["ssm"], "attn": {
        k: jnp.concatenate([c, jnp.zeros_like(c[:, :, :3])], axis=2)
        for k, c in rcache["attn"].items()}}
    nxt = _tokens(cfg, 2, 3, seed=2)
    for i in range(3):
        lg, cache = M.decode_step(cfg, params, cache,
                                  {"token": torch.from_numpy(nxt[:, i:i + 1]),
                                   "pos": 32 + i})
        rlg, rcache = RM.decode_step(rcfg, rparams, rcache,
                                     {"token": jnp.asarray(nxt[:, i:i + 1]),
                                      "pos": jnp.asarray(32 + i, jnp.int32)})
        np.testing.assert_allclose(_np(lg), _np(rlg), **MODEL_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache["attn"][k]),
                                   _np(rcache["attn"][k]), **MODEL_TOL)


def test_hybrid_prefill_equals_the_decode_only_loop(models):
    """Two SSD chunks of 16 and two shared-block applications: the
    launcher's decode-only loop lands on prefill's last logits to float32
    roundoff."""
    _, _, cfg, params, _ = models[(4, 2)]
    tok = torch.from_numpy(_tokens(cfg, 2, 32, seed=5))
    lg, _ = M.prefill(cfg, params, {"tokens": tok})
    g = prefill_gap.gap(lg, prefill_gap.decode_loop(cfg, params, tok))
    assert g["max_abs_rel"] <= 1e-5 and g["argmax_agree"] == 1.0


def test_hybrid_params_hold_one_unstacked_shared_block(models):
    """``shared_attn`` is one dense layer beside the stacked SSM layers;
    a tree that stacks it, or lacks it, is refused."""
    _, _, cfg, params, tree = models[(4, 2)]
    assert set(params) == {"embed", "ln_f", "layers", "shared_attn"}
    assert len(params["layers"]) == 4 and set(params["layers"][0]) == \
        {"ssm", "ln"}
    assert params["shared_attn"]["attn"]["wq"].shape == (256, 4 * 80)
    np.testing.assert_array_equal(_np(params["shared_attn"]["mlp"]["w_out"]),
                                  tree["shared_attn"]["mlp"]["w_out"])
    stacked = dict(tree, shared_attn=jax.tree.map(
        lambda a: np.stack([a, a]), tree["shared_attn"]))
    with pytest.raises(ValueError, match="shared_attn/.*shape"):
        M.params_from_numpy(cfg, stacked, device="cpu")
    with pytest.raises(ValueError, match="top-level keys"):
        M.params_from_numpy(cfg, {k: v for k, v in tree.items()
                                  if k != "shared_attn"}, device="cpu")


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "forward",
                                   "prefill", "decode_step"])
def test_hybrid_refuses_layers_that_do_not_group(entry, models):
    """``num_layers % attn_every != 0`` raises ``ValueError`` at every
    entry point (the reference fails there in a reshape)."""
    _, _, cfg, params, _ = models[(4, 2)]
    bad = cfg.replace(num_layers=5)
    tok = torch.zeros((1, 4), dtype=torch.long)
    calls = {
        "init_params": lambda: M.init_params(bad, torch.Generator(),
                                             device="cpu"),
        "init_cache": lambda: M.init_cache(bad, 1, 4, device="cpu"),
        "forward": lambda: M.forward(bad, params, {"tokens": tok}),
        "prefill": lambda: M.prefill(bad, params, {"tokens": tok}),
        "decode_step": lambda: M.decode_step(bad, params, {}, {
            "token": tok[:, :1], "pos": 0}),
    }
    with pytest.raises(ValueError, match="attn_every 2 does not divide "
                                         "num_layers 5"):
        calls[entry]()


def test_hybrid_prefill_reaches_k7_once_a_group_and_k8_once_a_layer(
        models, monkeypatch):
    """The card's dispatch, rehearsed on the CPU: with ``pick`` choosing
    the kernel wrappers (stood in for by their plain versions, counting
    and planning their launch), a prefill calls K7 once per group at hd
    80 on the hd-96 tiles and K8 once per SSM layer, and a decode step
    calls neither (its attention and SSM update are plain, as in the
    reference).  The logits are the plain path's."""
    _, _, cfg, params, _ = models[(4, 2)]
    tok = torch.from_numpy(_tokens(cfg, 2, 32, seed=6))
    want, _ = M.prefill(cfg, params, {"tokens": tok})
    seen = {"flash_attention": [], "ssd_chunk_state": []}

    def k7(q, k, v, **kw):
        out = fa.flash_attention_plain(q, k, v, **kw)
        seen["flash_attention"].append(fa.launch_plan(q, k, v, out))
        return out

    def k8(x, dt, A, Bm):
        seen["ssd_chunk_state"].append(tuple(x.shape))
        return ssd.ssd_chunk_state_plain(x, dt, A, Bm)

    monkeypatch.setattr(segment_sum, "pick", lambda card, plain, t: card)
    monkeypatch.setattr(fa, "flash_attention_cuda", k7)
    monkeypatch.setattr(ssd, "ssd_chunk_state_cuda", k8)
    got, cache = M.prefill(cfg, params, {"tokens": tok})
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert [p["tile_width"] for p in seen["flash_attention"]] == [96, 96]
    assert seen["ssd_chunk_state"] == [(2 * 2, 16, 16, 32)] * 4
    for v in seen.values():
        v.clear()
    cache["attn"] = {k: torch.cat([c, torch.zeros_like(c[:, :, :1])], 2)
                     for k, c in cache["attn"].items()}
    M.decode_step(cfg, params, cache, {"token": tok[:, :1], "pos": 32})
    assert seen == {"flash_attention": [], "ssd_chunk_state": []}


def test_prefill_gap_cuts_layers_and_its_control_moves_the_logits(capsys):
    """``prefill_gap --layers`` (the cut phase 15 reads on the card) keeps
    the config's widths: two groups of the reduced Zamba2 agree to
    roundoff, and the one-token control moves the logits far more."""
    flags = ["--arch", "zamba2-2.7b", "--reduced", "--layers", "4",
             "--batch", "2", "--prompt-len", "32", "--device", "cpu"]
    same = prefill_gap.run(flags)
    assert same["layers"] == 4 and same["d_model"] == 256
    assert same["max_abs_rel"] <= 1e-5 and same["argmax_agree"] == 1.0
    flip = prefill_gap.run(flags + ["--flip", "24"])
    assert flip["max_abs_rel"] >= 100 * max(same["max_abs_rel"], 1e-7)
