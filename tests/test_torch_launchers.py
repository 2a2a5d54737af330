"""The GNN launchers' ported options on the CPU: ``--reorder`` (training
is invariant under the relabelling; served requests and responses keep
their original ids), ``--dataset``, ``--sampler importance|fastgcn|
ladies``, the server's ``--update-stream`` / ``--update-every``, and the
trainer's distributed full-graph paths (``--devices 2 --device cpu``
under every ``--mode`` and ``--partitioner auto``; ``--fullgraph`` with
``--staleness``, ``--wire-codec int8`` and ``--update-stream``), spawned
once as one world of jobs, plus one run through ``main`` and one through
the command line.  The options still refused are held in
``test_torch_train.py`` and ``test_torch_serving.py``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.updates import load_update_stream, synthesize_updates
from repro_torch.graph.datasets import load
from repro_torch.launch import serve_gnn, train_gnn

SMALL = ["--device", "cpu", "--feat-dim", "8", "--hidden", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("policy", ["degree", "bfs", "rcm"])
@pytest.mark.parametrize("arch", ["gcn", "sage", "gat"])
def test_reordered_fullbatch_losses_match_unpacked(arch, policy):
    args = SMALL + ["--arch", arch, "--nodes", "96", "--epochs", "5"]
    base = train_gnn.main(args)
    res = train_gnn.main(args + ["--reorder", policy])
    np.testing.assert_allclose(res["losses"], base["losses"], rtol=1e-5,
                               atol=1e-5)
    assert abs(res["accuracy"] - base["accuracy"]) <= 1.0 / 96 + 1e-9
    rep = res["reorder"]
    assert rep["policy"] == policy and rep["seconds"] >= 0.0
    assert set(rep["locality"]) == {"edge_locality", "avg_gather_stride",
                                    "reuse_hit_rate"}
    np.testing.assert_array_equal(rep["perm"][rep["inv"]], np.arange(96))
    # the trainer's graph is the packed one
    assert res["graph"].num_edges == base["graph"].num_edges


def _serve(extra):
    return serve_gnn.main(SMALL + ["--nodes", "120", "--requests", "40",
                                   "--buckets", "4", "16"] + extra)


def _by_node(res):
    out = {}
    for r in res["responses"]:
        out.setdefault(r.node_id, []).append(np.asarray(r.logits))
    return out


@pytest.mark.parametrize("policy", ["bfs", "rcm"])
def test_reordered_serving_answers_in_original_ids(policy):
    """Fanouts above every degree make each node's sampled neighbourhood
    its whole neighbourhood, whatever its packed id: each response then
    equals the unpacked run's answer for the same original node."""
    wide = ["--fanouts", "64", "64"]
    base = _serve(wide)
    res = _serve(wide + ["--reorder", policy])
    for r in (res, res["no_cache"]):
        assert r["served"] == 40 and r["all_logits_finite"]
        assert [q.node_id for q in r["responses"]] == \
            [q.node_id for q in base["responses"]]
    want = _by_node(base)
    for node, logits in _by_node(res).items():
        for a in logits:
            np.testing.assert_allclose(a, want[node][0], rtol=1e-5,
                                       atol=1e-5)
    assert res["reorder"]["policy"] == policy


@pytest.mark.parametrize("reorder", ["none", "bfs"])
def test_update_stream_serves_every_request(tmp_path, reorder):
    g = train_gnn.load_graph(train_gnn.parse_args(SMALL + ["--nodes",
                                                           "120"]))
    path = str(tmp_path / "u.jsonl")
    n = synthesize_updates(g, 30, seed=4).to_jsonl(path)
    res = _serve(["--update-stream", path, "--update-every", "8",
                  "--reorder", reorder])
    for r in (res, res["no_cache"]):
        assert r["served"] == 40 and r["all_logits_finite"]
        assert r["update_seq"] == n
        assert sum(f["events"] for f in r["folds"]) == n
        assert len(r["folds"]) >= 2
    # the folded graph is the stream applied to the launcher's graph (in
    # the packed ids under --reorder)
    log = load_update_stream(path)
    srv = res["server"]
    if reorder == "none":
        want = log.apply(g)
    else:
        packed, _, inv = g.reordered(reorder)
        want = log.relabel(inv).apply(packed)
    np.testing.assert_array_equal(srv.g.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(srv.g.col_idx, want.col_idx)
    np.testing.assert_array_equal(srv.g.features, want.features)


@pytest.mark.parametrize("sampler", ["importance", "fastgcn", "ladies"])
def test_new_samplers_train_two_epochs(sampler):
    res = train_gnn.main(SMALL + ["--arch", "sage", "--minibatch",
                                  "--sampler", sampler, "--nodes", "96",
                                  "--epochs", "2", "--batch", "24"])
    assert res["mode"] == "minibatch_single" and res["steps"] == 8
    assert np.isfinite(res["losses"]).all()
    assert np.mean(res["losses"][-3:]) < np.mean(res["losses"][:3])


def test_train_gnn_loads_a_dataset():
    res = train_gnn.main(["--device", "cpu", "--arch", "gcn", "--dataset",
                          "citeseer-like", "--epochs", "3", "--hidden",
                          "16"])
    want = load("citeseer-like").graph
    g = res["graph"]
    np.testing.assert_array_equal(g.col_idx, want.col_idx)
    np.testing.assert_array_equal(g.features, want.features)
    assert res["model"][0].w.shape[0] == want.features.shape[1]
    assert np.isfinite(res["losses"]).all()


def test_serve_gnn_loads_a_dataset():
    res = serve_gnn.main(["--device", "cpu", "--dataset", "reddit-like",
                          "--requests", "16", "--hidden", "16",
                          "--buckets", "4", "16", "--cache", "none"])
    assert res["served"] == 16 and res["all_logits_finite"]
    want = load("reddit-like").graph
    assert res["server"].g.num_nodes == want.num_nodes
    assert res["server"].cfg.feat_dim == want.features.shape[1]
    assert res["server"].cfg.num_classes == want.num_classes


# ---------------------------------------------------------------------------
# the distributed full-graph paths (spawned gloo ranks on the CPU)
# ---------------------------------------------------------------------------

DIST = SMALL + ["--devices", "2", "--nodes", "144", "--epochs", "6"]
MODES = ("pull", "push", "stale", "hysync")


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """Every distributed launch of this file's checks as one world of 2
    ranks: the four modes, ``--partitioner auto``, the async trainer
    under int8 and with an update stream (40 events of the launcher's own
    graph, 10 folded an epoch)."""
    path = tmp_path_factory.mktemp("stream") / "u.jsonl"
    g = train_gnn.load_graph(train_gnn.parse_args(DIST[:-2] + ["--epochs",
                                                              "1"]))
    synthesize_updates(g, 40, seed=1).to_jsonl(str(path))
    jobs = {m: DIST + ["--mode", m] + (["--staleness", "2"] if m in (
        "stale", "hysync") else []) for m in MODES}
    jobs["auto"] = DIST + ["--partitioner", "auto"]
    jobs["int8"] = DIST + ["--fullgraph", "--staleness", "2",
                           "--wire-codec", "int8"]
    jobs["stream"] = DIST + ["--fullgraph", "--update-stream", str(path),
                             "--updates-per-epoch", "10"]
    res = train_gnn.run_world(list(jobs.values()), world=2, device="cpu",
                              timeout_s=240)
    return dict(zip(jobs, res))


@pytest.mark.parametrize("mode", MODES)
def test_train_gnn_distributed_modes(dist_runs, mode):
    res = dist_runs[mode]
    assert res["mode"] == mode and len(res["ranks"]) == 2
    losses = res["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert [r["losses"] for r in res["ranks"]] == [losses, losses]
    for r in res["ranks"]:
        for a, b in zip(r["params"], res["params"]):
            assert all(np.array_equal(a[k], b[k]) for k in a)
    # every collective of every epoch is counted
    assert all(e["bytes_received"] > 0 for e in res["epochs"])
    if mode != "pull":
        np.testing.assert_allclose(losses, dist_runs["pull"]["losses"],
                                   rtol=1e-5, atol=1e-6)


def test_train_gnn_auto_partitioner(dist_runs, capsys):
    res = dist_runs["auto"]
    assert res["partitioner"] in ("hash", "ldg")
    assert np.isfinite(res["losses"]).all()


def test_train_gnn_fullgraph_int8(dist_runs):
    res = dist_runs["int8"]
    st = res["stats"]
    assert st["wire_codec"] == "int8" and st["staleness"] == 2
    assert st["bytes_per_step"] < st["sync_bytes_per_step"]
    assert np.isfinite(res["losses"]).all()
    assert len({r["ghost_digest"] for r in res["ranks"]}) == 1
    assert 0.0 <= res["accuracy"] <= 1.0


def test_train_gnn_fullgraph_update_stream(dist_runs):
    res = dist_runs["stream"]
    assert res["update_seq"] == 40
    assert [f["events"] for f in res["folds"]] == [10, 10, 10, 10]
    assert all(f["touched_nodes"] > 0 and f["invalidated_rows"] > 0
               for f in res["folds"])
    assert np.isfinite(res["losses"]).all()
    drop = ("seconds",)
    assert [{k: v for k, v in f.items() if k not in drop}
            for f in res["ranks"][1]["folds"]] == \
        [{k: v for k, v in f.items() if k not in drop} for f in res["folds"]]


def test_train_gnn_main_runs_a_world(capsys):
    res = train_gnn.main(DIST + ["--mode", "push"])
    out = capsys.readouterr().out
    assert "backend gloo, world 2" in out and "ranks on cpu" in out
    assert res["mode"] == "push" and res["world"] == 2
    assert np.isfinite(res["losses"]).all()


def test_train_gnn_command_line_distributed():
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train_gnn",
                        *DIST, "--fullgraph", "--staleness", "1"],
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "final accuracy" in r.stdout and "KiB/step" in r.stdout
