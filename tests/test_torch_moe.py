"""The port's ``moe`` family (``models/transformer/moe.py``: the router,
GShard's grouped capacity dispatch, the gathered block; the model's
``moe`` layers; ``core/parallel.moe_expert_parallel``) against the
reference's JAX functions, on identical numpy inputs and parameters, in
float32.  The reference computes MoE in XLA (no Pallas kernel), so it
runs as it is on the CPU.

Blocks use Granite-MoE-1B-A400M's 32 experts, top 8, at a narrow width;
the capacity factor is Granite's 1.25 (tokens dropped), the reduced
configs' drop-free 8.0, or 0.5 over two groups of 1 024 tokens, where
the grouped block and the gathered one differ.  Tolerance: 1e-5 of the
largest reference value for blocks; 1e-4 (rtol and atol) for models'
logits, as ``tests/test_torch_transformer.py`` holds the other families.
Expert parallelism runs at worlds 2 and 4 over gloo, spawned once a
world as ``tests/test_torch_p3.py`` does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro.configs import base as ref_base
from repro.models.transformer import model as RM
from repro.models.transformer import moe as RMOE
from repro_torch.configs import base
from repro_torch.core import parallel as PL
from repro_torch.launch import prefill_gap, train_gnn
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer import moe as MOE
from test_torch_propagation import WORLD_TIMEOUT_S

GRANITE = "granite-moe-1b-a400m"
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# a Granite block at a narrow width: 32 experts, top 8
NARROW = dict(d_model=64, moe_d_ff=32, param_dtype="float32",
              compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(reduced=False, **kw):
    rc, c = ref_base.get_config(GRANITE), base.get_config(GRANITE)
    if reduced:
        rc, c = rc.reduced(), c.reduced()
    return rc.replace(**kw), c.replace(**kw)


def _block_params(rcfg, cfg, seed=0):
    """The reference's ``init_moe`` as numpy, and the port's tensors."""
    p = jax.tree.map(np.asarray, RMOE.init_moe(
        rcfg, jax.random.PRNGKey(seed), jnp.float32))
    return p, _torch_tree(p)


def _torch_tree(p):
    if isinstance(p, dict):
        return {k: _torch_tree(v) for k, v in p.items()}
    return torch.from_numpy(np.array(p))


def _x(B, S, D, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * top, f"max |diff| {err} > {rel} x {top}"


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_moe_fields_and_reduced_match_the_reference():
    """The MoE fields of the published config and of ``reduced()`` (the
    experts branch: 4 experts, top 2, width 128, factor 8.0), also with
    DeepSeek-V3's three leading dense layers, which ``reduced()`` cuts
    to one."""
    names = ("num_experts", "experts_per_token", "num_shared_experts",
             "moe_d_ff", "first_dense_layers", "moe_capacity_factor",
             "moe_impl")
    for kw in ({}, {"first_dense_layers": 3, "num_shared_experts": 1}):
        rc, c = _cfgs(**kw)
        for cut in ((rc, c), (rc.reduced(), c.reduced())):
            assert {n: getattr(cut[1], n) for n in names} == \
                {n: getattr(cut[0], n) for n in names}
    _, c = _cfgs()
    assert (c.num_experts, c.experts_per_token, c.moe_capacity_factor,
            c.moe_impl, c.padded_vocab) == (32, 8, 1.25, "gshard", 49408)
    assert {f.name for f in dataclasses.fields(base.ModelConfig)} >= \
        set(names)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", GRANITE])
def test_mla_fields_and_reduced_match_the_reference(arch):
    """The five MLA fields of the published config and of ``reduced()``
    (the MLA branch: q_lora 64, kv_lora 32, rope 16, nope 32, v 32;
    untouched, all 0, where the config has no MLA)."""
    names = ("q_lora_rank", "kv_lora_rank", "qk_rope_head_dim",
             "qk_nope_head_dim", "v_head_dim")
    rc, c = ref_base.get_config(arch), base.get_config(arch)
    for cut in ((rc, c), (rc.reduced(), c.reduced())):
        assert {n: getattr(cut[1], n) for n in names} == \
            {n: getattr(cut[0], n) for n in names}
    want = (1536, 512, 64, 128, 128) if c.family == "mla_moe" else \
        (0,) * 5
    assert tuple(getattr(c, n) for n in names) == want
    assert {f.name for f in dataclasses.fields(base.ModelConfig)} >= \
        set(names)


# ---------------------------------------------------------------------------
# the router and the blocks
# ---------------------------------------------------------------------------

def test_route_matches_the_reference():
    rcfg, cfg = _cfgs(**NARROW)
    p, tp = _block_params(rcfg, cfg)
    x = _x(2, 64, 64)
    w, idx, gates = MOE.route(cfg, tp, torch.from_numpy(x))
    rw, ridx, rgates = RMOE.route(rcfg, p, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _close(w.numpy(), rw)
    _close(gates.numpy(), rgates)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)


def _dropped_rows(rcfg, p, x, cf):
    """Rows whose output changes between capacity ``cf`` and a drop-free
    factor (the reference's own block)."""
    a = np.asarray(RMOE.moe_block(rcfg, p, jnp.asarray(x),
                                  capacity_factor=cf))
    b = np.asarray(RMOE.moe_block(rcfg, p, jnp.asarray(x),
                                  capacity_factor=8.0))
    return int((np.abs(a - b).max(-1) > 1e-6).sum())


@pytest.mark.parametrize("cf,kw", [
    (1.25, {}), (8.0, {}), (1.25, {"act": "gelu"}),
    (1.25, {"num_shared_experts": 1})])
def test_moe_block_matches_the_reference(cf, kw):
    """128 tokens, one group: Granite's factor drops tokens (asserted),
    8.0 drops none; GeGLU experts; one shared expert."""
    rcfg, cfg = _cfgs(**NARROW, **kw)
    p, tp = _block_params(rcfg, cfg)
    x = _x(2, 64, 64, seed=1)
    got = MOE.moe_block(cfg, tp, torch.from_numpy(x), capacity_factor=cf)
    want = RMOE.moe_block(rcfg, p, jnp.asarray(x), capacity_factor=cf)
    _close(got.numpy(), want)
    dropped = _dropped_rows(rcfg, p, x, cf)
    assert (dropped > 0) == (cf < 4.0), dropped


def test_moe_block_over_two_groups_is_grouped_not_gathered():
    """T = 2 048 at factor 0.5: two groups of 1 024, each with its own
    capacity.  The port equals the reference's grouped block and differs
    from its gathered one (one group of 2 048) in most rows."""
    rcfg, cfg = _cfgs(**NARROW)
    p, tp = _block_params(rcfg, cfg)
    x = _x(2, 1024, 64, seed=2)
    got = MOE.moe_block(cfg, tp, torch.from_numpy(x),
                        capacity_factor=0.5).numpy()
    want = np.asarray(RMOE.moe_block(rcfg, p, jnp.asarray(x),
                                     capacity_factor=0.5))
    gathered = np.asarray(RMOE.moe_block_gathered(
        rcfg, p, jnp.asarray(x), capacity_factor=0.5))
    _close(got, want)
    differ = (np.abs(got - gathered).max(-1) > 1e-3).mean()
    assert differ > 0.25, differ


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_block_gathered_matches_the_reference(cf):
    rcfg, cfg = _cfgs(**NARROW)
    p, tp = _block_params(rcfg, cfg)
    x = _x(3, 50, 64, seed=3)
    got = MOE.moe_block_gathered(cfg, tp, torch.from_numpy(x),
                                 capacity_factor=cf)
    _close(got.numpy(), RMOE.moe_block_gathered(
        rcfg, p, jnp.asarray(x), capacity_factor=cf))


def test_moe_block_refuses_tokens_that_do_not_divide_into_groups():
    _, cfg = _cfgs(**NARROW)
    p = MOE.init_moe(cfg, torch.Generator().manual_seed(0), torch.float32,
                     "cpu")
    with pytest.raises(ValueError, match="1500 tokens"):
        MOE.moe_block(cfg, p, torch.zeros(3, 500, 64))
    # T <= group_size is one group of T, whatever T is
    assert MOE.moe_block(cfg, p, torch.zeros(3, 7, 64)).shape == (3, 7, 64)


# ---------------------------------------------------------------------------
# the moe family's model
# ---------------------------------------------------------------------------

# reduced Granite (4 experts, top 2, drop-free 8.0) and a reduced cut
# with Granite's 32 experts, top 8 and factor 1.25 (tokens dropped)
MODEL_CUTS = {"reduced": {},
              "published_routing": {"num_experts": 32,
                                    "experts_per_token": 8,
                                    "moe_capacity_factor": 1.25}}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw in MODEL_CUTS.items():
        rcfg, cfg = _cfgs(reduced=True, **kw)
        tree = jax.tree.map(np.asarray, RM.init_params(
            rcfg, jax.random.PRNGKey(0)))
        out[name] = (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
                     M.params_from_numpy(cfg, tree, device="cpu"), tree)
    return out


def _tokens(cfg, B, S_, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S_)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("cut", list(MODEL_CUTS))
def test_moe_forward_matches_the_reference(cut, models):
    rcfg, rparams, cfg, params, _ = models[cut]
    assert M.param_count(params) == RM.param_count(rparams)
    assert set(params["layers"][0]) == {"attn", "moe", "ln1", "ln2"}
    tok = _tokens(cfg, 2, 32)
    got = M.forward(cfg, params, {"tokens": torch.from_numpy(tok)})
    want = RM.forward(rcfg, rparams, {"tokens": jnp.asarray(tok)})
    assert got.shape == (2, 32, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)


@pytest.mark.parametrize("cut", list(MODEL_CUTS))
def test_moe_prefill_cache_and_decode_match_the_reference(cut, models):
    """prefill's last logits and its K/V cache, then three decode steps
    in the grown cache (a decode step groups the batch, as the
    reference's does)."""
    rcfg, rparams, cfg, params, _ = models[cut]
    tok = _tokens(cfg, 2, 24, seed=1)
    lg, cache = M.prefill(cfg, params, {"tokens": torch.from_numpy(tok)})
    rlg, rcache = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(_np(lg), _np(rlg), **MODEL_TOL)
    assert sorted(cache) == sorted(rcache) == ["k", "v"]
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache[k]), _np(rcache[k]),
                                   **MODEL_TOL)
    cache = {k: torch.cat([c, torch.zeros_like(c[:, :, :3])], 2)
             for k, c in cache.items()}
    rcache = {k: jnp.concatenate([c, 0 * c[:, :, :3]], 2)
              for k, c in rcache.items()}
    nxt = _tokens(cfg, 2, 3, seed=2)
    for i in range(3):
        lg, cache = M.decode_step(cfg, params, cache, {
            "token": torch.from_numpy(nxt[:, i:i + 1]), "pos": 24 + i})
        rlg, rcache = RM.decode_step(rcfg, rparams, rcache, {
            "token": jnp.asarray(nxt[:, i:i + 1]),
            "pos": jnp.asarray(24 + i, jnp.int32)})
        np.testing.assert_allclose(_np(lg), _np(rlg), **MODEL_TOL)


def test_moe_prefill_against_the_decode_only_loop_drop_free():
    """At factor 8.0 (drop-free on both sides: a prefill groups the
    prompt, a decode step the batch) prefill's last logits equal the
    decode-only loop's; at Granite's 1.25 the two drop other tokens, and
    ``prefill_gap --capacity-factor`` sets the factor for both."""
    flags = ["--arch", GRANITE, "--reduced", "--batch", "2",
             "--prompt-len", "24", "--device", "cpu"]
    free = prefill_gap.run(flags + ["--capacity-factor", "8.0"])
    assert free["capacity_factor"] == 8.0
    assert free["max_abs_rel"] <= 1e-5 and free["argmax_agree"] == 1.0
    flip = prefill_gap.run(flags + ["--capacity-factor", "8.0", "--flip",
                                    "20"])
    assert flip["max_abs_rel"] >= 100 * max(free["max_abs_rel"], 1e-7)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

def test_expert_parallel_without_a_world_is_the_gathered_block():
    rcfg, cfg = _cfgs(**NARROW)
    _, tp = _block_params(rcfg, cfg)
    x = torch.from_numpy(_x(2, 40, 64, seed=4))
    assert torch.equal(PL.moe_expert_parallel(cfg, tp, x),
                       MOE.moe_block_gathered(cfg, tp, x,
                                              capacity_factor=1.25))
    with pytest.raises(ValueError, match="32 % 3"):
        PL.expert_slice(32, 0, 3)
    shard = PL.expert_shard(cfg, tp, 1, 4)
    assert torch.equal(shard["w_out"], tp["w_out"][8:16])
    assert shard["router"] is tp["router"]


@pytest.fixture(scope="module")
def ep_worlds():
    """Each world runs: Granite's block (32 experts, top 8, factor 1.25,
    128 tokens) with each rank holding its experts, and reduced
    Granite's forward with ``moe_impl="ep"``."""
    rcfg, cfg = _cfgs(**NARROW)
    p, _ = _block_params(rcfg, cfg, seed=5)
    x = _x(2, 64, 64, seed=5)
    mrc, mc = _cfgs(reduced=True, moe_impl="ep")
    tree = jax.tree.map(np.asarray, RM.init_params(mrc, jax.random.PRNGKey(1)))
    tok = _tokens(mc, 2, 16, seed=6)
    jobs = [functools.partial(R.moe_ep_run, cfg=cfg, params=p, x=x,
                              capacity_factor=1.25),
            functools.partial(R.moe_ep_forward, cfg=mc, tree=tree,
                              tokens=tok)]
    want = {"block": np.asarray(RMOE.moe_block_gathered(
        rcfg, p, jnp.asarray(x), capacity_factor=1.25)),
        "forward": _np(RM.forward(mrc, jax.tree.map(jnp.asarray, tree),
                                  {"tokens": jnp.asarray(tok)}))}
    worlds = {w: dict(zip(("block", "forward"), train_gnn.run_world(
        jobs, world=w, device="cpu", timeout_s=WORLD_TIMEOUT_S)))
        for w in (2, 4)}
    return worlds, want


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_block_matches_the_gathered_reference(ep_worlds,
                                                              world):
    worlds, want = ep_worlds
    ranks = worlds[world]["block"]["ranks"]
    assert [r["experts"] for r in ranks] == [32 // world] * world
    _close(ranks[0]["y"], want["block"])
    for r in ranks[1:]:
        assert np.array_equal(r["y"], ranks[0]["y"])


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_model_forward_matches_the_reference(ep_worlds,
                                                             world):
    """reduced Granite with ``moe_impl="ep"`` (4 experts over the ranks)
    against the reference's forward with it, which computes the gathered
    block without sharding rules."""
    worlds, want = ep_worlds
    ranks = worlds[world]["forward"]["ranks"]
    np.testing.assert_allclose(ranks[0]["logits"], want["forward"],
                               **MODEL_TOL)
    for r in ranks[1:]:
        assert np.array_equal(r["logits"], ranks[0]["logits"])
