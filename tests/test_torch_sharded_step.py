"""The model under the sharding rules computes the function it computes
unsharded: a spawned 4-rank gloo world (``tests/torch_dist_ranks.py``'s
``sharded_lm_step``) runs a reduced float32 config's train step (AdamW,
per-layer remat) and prefill on DTensors over a 2x2 ("data", "model")
mesh, params placed by ``param_specs`` (FSDP on for the step), and on
plain tensors; the loss, the grad norm, the prefill's logits and a
decode step's agree within 1e-5.  The cases here cover the dense block
(GQA with the KV heads split and, at one KV head, every rank taking its
query heads' group), a sliding window (the decode softmax over a ring
split along its sequence, and a decode step in the prefill's own ring,
its rows rolled into their slots), the experts split over ``model``
(GShard groups that span the batch shards; ``moe_impl="ep"``, each
batch shard's tokens one group, against the plain GShard block, both
drop-free), and the SSD with its heads split;
``test_torch_sharded_step_families.py`` covers the other families."""
import functools

import numpy as np
import pytest

from repro_torch.launch import train_gnn

import torch_dist_ranks as R

CASES = {"dense": ("qwen2.5-14b", None, None),
         "dense-one-kv-head": ("qwen2.5-14b", {"num_kv_heads": 1}, None),
         "dense-window": ("qwen2.5-14b", {"sliding_window": 12}, None),
         "moe": ("granite-moe-1b-a400m", None, None),
         "moe-ep": ("granite-moe-1b-a400m", {"moe_impl": "ep"},
                    {"moe_impl": "gshard"}),
         "ssm": ("mamba2-780m", None, None)}


def run_cases(cases) -> dict:
    """Each case's ``sharded_lm_step`` in one spawned 4-rank world:
    ``{case: rank 0's summary, every rank's under "ranks"}``."""
    jobs = [functools.partial(R.sharded_lm_step, arch=a, overrides=o,
                              plain_overrides=po)
            for a, o, po in cases.values()]
    ranks = train_gnn.run_world(jobs, world=4, device="cpu", timeout_s=600)
    return dict(zip(cases, ranks))


def check_step_and_prefill(res):
    for r in res["ranks"]:
        (pl, pg, plog, *_), (sl, sg, slog, *_) = r["plain"], r["sharded"]
        assert np.isfinite(pl) and np.isfinite(pg)
        assert sl == pytest.approx(pl, rel=1e-5, abs=1e-5)
        assert sg == pytest.approx(pg, rel=1e-5, abs=1e-5)
        scale = float(np.max(np.abs(plog)))
        np.testing.assert_allclose(slog, plog, rtol=0, atol=1e-5 * scale)


def check_decode(res):
    """Each decode step over a cache split along its sequence (the slot's
    owner writes it; the softmax runs per shard and combines) gives the
    unsharded step's logits within 1e-5 of the largest."""
    for r in res["ranks"]:
        for want, got in zip(r["plain"][3:], r["sharded"][3:]):
            if want is None:
                assert got is None
                continue
            assert np.all(np.isfinite(want))
            scale = float(np.max(np.abs(want)))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def world():
    return run_cases(CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_and_prefill_match_unsharded(world, case):
    check_step_and_prefill(world[case])


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_decode_step_matches_unsharded(world, case):
    check_decode(world[case])


def test_window_case_decodes_in_the_prefill_ring(world):
    """The windowed case's second decode step ran on both sides (its
    prompt outgrows the ring, so the prefill rolled its rows into their
    slots); without a window there is none."""
    for r in world["dense-window"]["ranks"]:
        assert r["plain"][4] is not None and r["sharded"][4] is not None
    assert world["dense"]["plain"][4] is None


def test_host_mesh_is_the_identity_plan():
    """``make_host_mesh``: the degenerate 1x1 ("data", "model") mesh on the
    local device of a one-rank world; a forward with the params placed on
    it by the rules equals the plain forward within 1e-5 of the largest
    logit (every collective of a 1x1 mesh moves nothing)."""
    res = train_gnn.run_world(
        [functools.partial(R.host_mesh_forward, arch="qwen2.5-14b")],
        world=1, device="cpu", timeout_s=300)[0]
    assert res["axes"] == ["data", "model"] and res["shape"] == [1, 1]
    scale = float(np.max(np.abs(res["plain"])))
    np.testing.assert_allclose(res["sharded"], res["plain"], rtol=0,
                               atol=1e-5 * scale)
