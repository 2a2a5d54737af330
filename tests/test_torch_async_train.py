"""The port's staleness-bounded asynchronous full-graph trainer against
the reference's: 10 epochs at S 0 and 2 (``refresh_frac`` 0.05) at 2 and
4 ranks within 1e-5 per parameter, the same bytes per step, S 0 within
1e-5 of the port's own pull step, every rank's ghost planes bitwise equal;
an update stream folded between epochs touches and invalidates what the
reference's does; the in-step codec (``WireCodec.qdq`` on a tensor) is
bitwise the reference's ``jax_qdq`` (bf16; int8 on normal ranges) and
keeps the port's repaired scale on subnormal ranges; an int8 run moves at
most 0.35 of fp32's bytes within 5 % of its loss
(``tests/async_train_check.py``'s bounds).

The reference runs once for the file in a subprocess with forced host
devices; each world is spawned once, every case a job of it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro.core.comm import resolve_codec as ref_codec
from repro_torch.core.comm import resolve_codec
from repro_torch.launch import train_gnn
from test_torch_propagation import (WORLD_TIMEOUT_S, max_diff, params0,
                                    ranks_equal, reference)

TOL = 1e-5


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference("async", tmp_path_factory)


@pytest.fixture(scope="module")
def worlds(ref):
    p0 = params0(ref)
    out = {}
    for world in (2, 4):
        jobs = {("async", s): functools.partial(R.async_run, staleness=s,
                                                params0=p0)
                for s in (0, 2)}
        jobs["pull"] = functools.partial(R.sync_run, mode="pull", params0=p0)
        if world == 2:
            jobs["fold"] = functools.partial(R.fold_run, params0=p0)
            jobs["int8"] = functools.partial(R.async_run, staleness=0,
                                             params0=p0, refresh_frac=0.0,
                                             codec="int8")
            jobs["fp32"] = functools.partial(R.async_run, staleness=0,
                                             params0=p0, refresh_frac=0.0)
        res = train_gnn.run_world(list(jobs.values()), world=world,
                                  device="cpu", timeout_s=WORLD_TIMEOUT_S)
        out[world] = dict(zip(jobs, res))
    return out


@pytest.mark.parametrize("staleness", [0, 2])
@pytest.mark.parametrize("world", [2, 4])
def test_async_matches_the_reference(worlds, ref, world, staleness):
    res = worlds[world][("async", staleness)]
    key = f"async/{staleness}/{world}"
    err = max_diff(res["params"], ref, key)
    assert err <= TOL, f"{key}: parameters off by {err}"
    assert res["stats"]["bytes_per_step"] == float(
        ref[f"{key}/bytes_per_step"])
    assert ranks_equal(res)
    assert len({r["ghost_digest"] for r in res["ranks"]}) == 1


@pytest.mark.parametrize("world", [2, 4])
def test_async_s0_is_the_pull_step(worlds, world):
    pull = worlds[world]["pull"]["params"]
    a0 = worlds[world][("async", 0)]["params"]
    err = max(float(np.abs(pull[i][k] - a0[i][k]).max())
              for i in range(2) for k in ("w", "b"))
    assert err <= TOL, err


def test_bytes_fall_with_staleness(worlds):
    for world in (2, 4):
        b = [worlds[world][("async", s)]["stats"]["bytes_per_step"]
             for s in (0, 2)]
        assert b[0] > b[1] > 0


def test_int8_moves_a_third_of_the_bytes_at_the_same_loss(worlds):
    fp32, int8 = worlds[2]["fp32"], worlds[2]["int8"]
    ratio = (int8["stats"]["bytes_per_step"]
             / fp32["stats"]["bytes_per_step"])
    assert ratio <= 0.35, ratio
    assert np.isfinite(int8["losses"]).all()
    assert abs(int8["losses"][-1] - fp32["losses"][-1]) \
        <= 0.05 * abs(fp32["losses"][-1])
    assert len({r["ghost_digest"] for r in int8["ranks"]}) == 1


def test_fold_updates_as_the_reference(worlds, ref):
    res = worlds[2]["fold"]
    assert res["folds"] == ref["fold/summaries"].tolist()
    for r in res["ranks"]:
        np.testing.assert_array_equal(r["versions"], ref["fold/versions"])
    err = max_diff(res["params"], ref, "fold")
    assert err <= TOL, err


def _rows(seed, n=64, d=48, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * scale
    x[3] = 1.5                                   # a constant row
    x[5, ::2] = 0.0
    return x


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
def test_in_step_qdq_is_bitwise_the_reference(codec, scale):
    x = _rows(7, scale=scale)
    got = resolve_codec(codec).qdq(torch.from_numpy(x))
    want = np.asarray(jax.jit(ref_codec(codec).jax_qdq)(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_in_step_int8_keeps_the_repaired_scale_on_subnormal_rows():
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    x = (np.arange(48, dtype=np.float32)[None, :] * tiny
         * np.arange(1, 9, dtype=np.float32)[:, None])
    got = resolve_codec("int8").qdq(torch.from_numpy(x)).numpy()
    host = resolve_codec("int8").qdq(x)
    np.testing.assert_array_equal(got, host)
    span = x.max(1) - x.min(1)
    assert (np.abs(got - x).max(1) <= span / 255 / 2 + tiny).all()
