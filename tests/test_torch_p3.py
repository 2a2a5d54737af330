"""The port's P3 hybrid step (``core/parallel.py``: layer 1 model-parallel
over the feature columns, reduce-scattered partials; deeper layers
all-gathered) at 2 and 4 ranks from the reference's initial parameters:
10 SGD steps against the reference's ``make_p3_train_step``, 10 AdamW
steps against the reference's single-device full-graph GCN (the
function P3 computes: the reference's P3 clips AdamW's gradients by each
device's own W1 slice, a defect the port does not copy), each parameter
and each step's loss within 1e-5; the replicated parameters bitwise
equal on every rank.  W1's gradient is the rank's
slice of the single-process gradient and is left unsummed, every other
gradient is summed over the ranks; a feature width the world does not
divide raises.

The reference runs once for the file, in a subprocess with forced host
devices (``tests/torch_dist_reference.py p3``); each world is spawned
once, every case a job of it.
"""
import functools

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch.core import parallel as PL
from repro_torch.core import propagation as PR
from repro_torch.core.abstraction import DeviceGraph
from repro_torch.launch import train_gnn
from repro_torch.models.gnn import model as GM
from test_torch_propagation import WORLD_TIMEOUT_S, params0, reference

TOL = 1e-5
OPTS = ("adamw", "sgd")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference("p3", tmp_path_factory)


@pytest.fixture(scope="module")
def worlds(ref):
    p0 = params0(ref)
    jobs = [functools.partial(R.p3_run, params0=p0, opt=o) for o in OPTS]
    jobs.append(functools.partial(R.p3_grads, params0=p0))
    return {world: dict(zip(OPTS + ("grads",), train_gnn.run_world(
        jobs, world=world, device="cpu", timeout_s=WORLD_TIMEOUT_S)))
        for world in (2, 4)}


def full_params(res) -> list:
    """The ranks' parameters as one model: W1's slices in rank order."""
    ranks = [r["params"] for r in res["ranks"]]
    out = [dict(p) for p in ranks[0]]
    out[0]["w"] = np.concatenate([p[0]["w"] for p in ranks])
    return out


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("world", [2, 4])
def test_p3_matches_the_reference(worlds, ref, world, opt):
    res = worlds[world][opt]
    key = f"p3/{opt}/{world}" if opt == "sgd" else "p3/adamw/single"
    ours = full_params(res)
    err = max(float(np.abs(ours[i][k] - ref[f"{key}/{i}/{k}"]).max())
              for i in range(2) for k in ("w", "b"))
    assert err <= TOL, f"{key}: parameters off by {err}"
    np.testing.assert_allclose(res["losses"], ref[f"{key}/losses"],
                               rtol=0, atol=TOL)
    first = res["ranks"][0]
    for r in res["ranks"]:
        assert r["losses"] == first["losses"]
        for i in range(2):
            for k in ("w", "b"):
                if (i, k) != (0, "w"):
                    assert np.array_equal(r["params"][i][k],
                                          first["params"][i][k])


@pytest.mark.parametrize("world", [2, 4])
def test_w1_gradient_kept_and_the_others_summed(worlds, ref, world):
    """W1's gradient on rank r is the single-process gradient's rows of
    r's columns, untouched by the sum; every other gradient is the sum
    over the ranks, in rank order."""
    ranks = worlds[world]["grads"]["ranks"]
    g = R.graph()
    cfg = GM.GNNConfig(**R.CFG)
    model = GM.params_from_numpy(cfg, params0(ref), device="cpu")
    dg = DeviceGraph.from_graph(g, "cpu", src_layout=True)
    y = torch.from_numpy(g.labels)
    GM.nll_loss(GM.forward_full(cfg, model, dg, torch.from_numpy(
        g.features)), y).backward()
    for r, res in enumerate(ranks):
        cols = PL.feature_slice(cfg.feat_dim, r, world)
        w1 = res["after"][0]["w"]
        assert np.array_equal(w1, res["before"][0]["w"])
        np.testing.assert_allclose(w1, model[0].w.grad.numpy()[cols],
                                   rtol=0, atol=1e-6)
        for i in range(2):
            for k in ("w", "b"):
                if (i, k) == (0, "w"):
                    continue
                total = ranks[0]["before"][i][k].copy()
                for q in ranks[1:]:
                    total += q["before"][i][k]
                assert np.array_equal(res["after"][i][k], total), (i, k)
                np.testing.assert_allclose(
                    total, getattr(model[i], k).grad.numpy(), rtol=0,
                    atol=1e-6)


def test_a_feature_width_the_world_does_not_split_raises():
    g = R.graph()                                   # 16 features
    cfg = GM.GNNConfig(**R.CFG)
    with pytest.raises(ValueError, match="16 % 3"):
        PL.feature_slice(16, 0, 3)
    p = [{k: v.detach().numpy() for k, v in layer.named_parameters()}
         for layer in GM.init_gnn(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")]
    with pytest.raises(ValueError, match="16 % 3"):
        PL.p3_params(cfg, p, 0, 3, device="cpu")
    with pytest.raises(ValueError, match="16 % 3"):
        PL.p3_shard(PR.shard_graph(g, 3), g, 0, "cpu")


def test_the_reference_p3_drifts_under_adamw(ref):
    """The defect the port does not copy: the reference's P3 under AdamW
    leaves its single-device GCN (it clips by a device's W1 slice)."""
    err = max(float(np.abs(ref[f"p3/adamw/{w}/{i}/{k}"]
                           - ref[f"p3/adamw/single/{i}/{k}"]).max())
              for w in (2, 4) for i in range(2) for k in ("w", "b"))
    assert err > 10 * TOL, err
