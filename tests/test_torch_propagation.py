"""The port's synchronous distributed full-graph GCN against the
reference's ``shard_map`` steps: pull, push and stale (DistGNN's delayed
halo) at 2 and 4 ranks, 10 AdamW and 10 SGD steps from the reference's
initial parameters, each parameter within 1e-5 (the north star's bar);
every rank ends with bitwise-equal parameters; the parameter-server and
all-reduce coordinators agree; a failing rank fails the launch.

The reference runs once for the file, in a subprocess with forced host
devices (``tests/torch_dist_reference.py``); the port runs each world
once, every case a job of it (``train_gnn.run_world``: spawned gloo ranks
on the CPU, joined from a file store, killed and failed on a timeout).
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_ranks as R
from repro_torch.launch import train_gnn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("pull", "push", "stale")
OPTS = ("adamw", "sgd")
TOL = 1e-5
WORLD_TIMEOUT_S = 240


def reference(what: str, tmp_path_factory) -> dict:
    """The reference's results of ``tests/torch_dist_reference.py what``."""
    out = tmp_path_factory.mktemp("ref") / f"{what}.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "tests", "torch_dist_reference.py"), what, str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(out))


def params0(ref) -> list:
    return [{k: ref[f"init/{i}/{k}"] for k in ("w", "b")} for i in range(2)]


def max_diff(params, ref, key) -> float:
    return max(float(np.abs(params[i][k] - ref[f"{key}/{i}/{k}"]).max())
               for i in range(2) for k in ("w", "b"))


def ranks_equal(res) -> bool:
    first = res["ranks"][0]["params"]
    return all(np.array_equal(r["params"][i][k], first[i][k])
               for r in res["ranks"] for i in range(2) for k in ("w", "b"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference("propagation", tmp_path_factory)


@pytest.fixture(scope="module")
def worlds(ref):
    """Each world spawned once: every (mode, optimizer) case, then the
    coordinators."""
    p0 = params0(ref)
    jobs = [functools.partial(R.sync_run, mode=m, params0=p0, opt=o)
            for m in MODES for o in OPTS] + [R.coordination_run]
    out = {}
    for world in (2, 4):
        res = train_gnn.run_world(jobs, world=world, device="cpu",
                                  timeout_s=WORLD_TIMEOUT_S)
        out[world] = dict(zip([(m, o) for m in MODES for o in OPTS]
                              + ["coordination"], res))
    return out


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_sync_modes_match_the_reference(worlds, ref, world, mode, opt):
    res = worlds[world][(mode, opt)]
    key = f"{mode}/{opt}/{world}"
    err = max_diff(res["params"], ref, key)
    assert err <= TOL, f"{key}: parameters off by {err}"
    np.testing.assert_allclose(res["losses"], ref[f"{key}/losses"],
                               rtol=0, atol=TOL)
    assert ranks_equal(res), f"{key}: the ranks' parameters differ"


@pytest.mark.parametrize("world", [2, 4])
def test_modes_agree_with_each_other(worlds, world):
    """Push and stale compute pull's function (the reference holds push
    to 1e-3; here every mode is within 1e-5 of pull)."""
    pull = worlds[world][("pull", "adamw")]["params"]
    for mode in ("push", "stale"):
        other = worlds[world][(mode, "adamw")]["params"]
        err = max(float(np.abs(pull[i][k] - other[i][k]).max())
                  for i in range(2) for k in ("w", "b"))
        assert err <= TOL, f"{mode} vs pull: {err}"


@pytest.mark.parametrize("world", [2, 4])
def test_parameter_server_matches_allreduce(worlds, world):
    for r in worlds[world]["coordination"]["ranks"]:
        assert r["max_diff"] <= 1e-5
        # the PS gathered every gradient and broadcast the parameters
        assert {"all_gather", "broadcast"} <= set(r["comm"]["calls"])


def _fails_on_rank_one(rank, world, dev):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    import torch

    from repro_torch.core import collectives as C
    if rank == 1:
        raise ValueError("rank one fails")
    return {"sum": float(C.all_reduce_sum(torch.ones(3)).sum())}


def test_a_failing_rank_fails_the_launch():
    """The launch raises (no rank is left waiting on the dead one)."""
    with pytest.raises(RuntimeError, match="a rank failed"):
        train_gnn.run_world([_fails_on_rank_one], world=2, device="cpu",
                            timeout_s=WORLD_TIMEOUT_S)
