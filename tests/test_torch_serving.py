"""The serving slice as a whole, port against reference: the same SBM
graph from both generators, both ``GNNInferenceServer``s with the same
weights (the reference through its Pallas kernels in interpret mode),
driven batch by batch with one fixed sequence of micro-batches.  Logits
agree to 1e-5; cache and traffic accounting agree exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.graph import generators as RG
from repro.models.gnn import model as RGM
from repro.serving import GNNInferenceServer as RefServer
from repro.serving.batcher import MicroBatch as RefMicroBatch
from repro_torch.checkpoint import latest_step
from repro_torch.core.updates import synthesize_updates
from repro_torch.graph import generators as G
from repro_torch.launch import serve_gnn
from repro_torch.models.gnn import model as GM
from repro_torch.serving import GNNInferenceServer, poisson_workload
from repro_torch.serving.batcher import MicroBatch

TOL = dict(rtol=1e-5, atol=1e-5)
NODES, FEAT, HIDDEN, FANOUTS, BUCKETS = 160, 8, 16, [3, 4], [4, 16]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker
    avoids oversubscribing the cores the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(gen):
    g = gen.sbm(NODES, 4, p_in=0.9, p_out=0.02, seed=5)
    return gen.featurize(g, FEAT, seed=5, class_sep=1.5)


def test_generators_are_bit_identical():
    ref, got = _graph(RG), _graph(G)
    np.testing.assert_array_equal(got.row_ptr, ref.row_ptr)
    np.testing.assert_array_equal(got.col_idx, ref.col_idx)
    np.testing.assert_array_equal(got.features, ref.features)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.features.dtype == ref.features.dtype


def _batches():
    """A fixed batch sequence: repeats (cache hits at staleness 0), a
    full bucket, and partly padded ones."""
    rng = np.random.default_rng(9)
    out = []
    for bucket, n in [(4, 3), (16, 16), (16, 9), (4, 4), (16, 12)]:
        ids = np.full(bucket, -1, np.int64)
        ids[:n] = rng.choice(NODES, n, replace=False)
        out.append((ids, bucket))
    out.append(out[1])                       # a repeat: cache hits
    return out


@pytest.mark.parametrize("arch,policy", [("sage", "degree"),
                                         ("sage", "none"),
                                         ("gat", "degree")])
def test_serve_batch_matches_reference(arch, policy):
    ref_g, g = _graph(RG), _graph(G)
    kw = dict(arch=arch, feat_dim=FEAT, hidden=HIDDEN,
              num_classes=g.num_classes, num_layers=2)
    ref_cfg = RGM.GNNConfig(use_kernel=True, **kw)
    params = RGM.init_gnn(ref_cfg, jax.random.PRNGKey(2))
    model = GM.params_from_numpy(GM.GNNConfig(**kw),
                                 jax.tree.map(np.asarray, params),
                                 device="cpu")
    skw = dict(fanouts=FANOUTS, buckets=BUCKETS, cache_policy=policy,
               cache_capacity=NODES // 4, seed=3)
    ref_srv = RefServer(ref_g, ref_cfg, params, **skw)
    srv = GNNInferenceServer(g, GM.GNNConfig(**kw), model, **skw)
    for ids, bucket in _batches():
        real = ids >= 0
        want = ref_srv.serve_batch(RefMicroBatch([], ids, bucket, 0.0))
        got = srv.serve_batch(MicroBatch([], ids, bucket, 0.0))
        assert got.shape == (bucket, g.num_classes)
        np.testing.assert_allclose(got[real], np.asarray(want)[real], **TOL)
    ref_stats, stats = ref_srv.summary(), srv.summary()
    for key in ("embedding_hits", "embedding_misses", "feature_bytes",
                "fill_bytes", "wire_bytes", "jit_entries"):
        assert stats[key] == ref_stats[key], key
    if policy == "degree":
        assert stats["embedding_hits"] > 0
    assert srv.forward_calls == len(_batches())


def test_serve_gnn_main_smoke_on_cpu():
    res = serve_gnn.main(["--device", "cpu", "--nodes", "120",
                          "--requests", "32", "--feat-dim", "8",
                          "--hidden", "16", "--fanouts", "3", "3",
                          "--buckets", "4", "16"])
    assert res["served"] == 32 and res["no_cache"]["served"] == 32
    assert res["all_logits_finite"] and res["no_cache"]["all_logits_finite"]
    assert res["jit_entries"] <= 2


SMALL = ["--device", "cpu", "--nodes", "120", "--feat-dim", "8",
         "--hidden", "16", "--fanouts", "3", "3", "--buckets", "4", "16"]


def test_serve_gnn_replicated_main_resumes_its_checkpoint(tmp_path):
    """Two runs of the replicated launcher on one checkpoint directory:
    the first autoscales and hot-swaps, then saves its version; the
    second resumes that version (a rollout staged before its run) and
    hot-swaps on from it."""
    argv = SMALL + ["--requests", "64", "--replicas", "2", "--autoscale",
                    "--max-replicas", "3", "--rate", "8000",
                    "--hot-swap-every", "16", "--ckpt-dir", str(tmp_path)]
    first = serve_gnn.main(argv)
    assert first["served"] == 64 and first["dropped"] == 0
    assert first["torn_batches"] == 0 and first["all_logits_finite"]
    assert first["hot_swaps"] >= 1
    saved = first["params_version"]
    assert saved == first["hot_swaps"] and latest_step(str(tmp_path)) == saved
    assert sum(first["version_counts"].values()) == 64
    router = first["router"]
    fwd = router.replicas[0].server._forward
    assert all(r.server._forward is fwd for r in router.replicas)

    second = serve_gnn.main(argv)
    assert second["served"] == 64 and second["dropped"] == 0
    assert second["torn_batches"] == 0
    # the resume is a rollout of its own, then the run's swaps follow it
    final = saved + second["hot_swaps"] - 1
    assert second["params_version"] == final
    versions = {int(v) for v in second["version_counts"]}
    assert versions <= {0} | set(range(saved, final + 1)), versions
    assert latest_step(str(tmp_path)) == final


def test_serve_gnn_replicated_reorder_and_update_stream(tmp_path):
    """The router under --reorder bfs and --update-stream: every event
    folded into the fleet's graph, responses in the clients' ids."""
    path = str(tmp_path / "u.jsonl")
    g = G.featurize(G.sbm(120, 4, p_in=0.9, p_out=0.02, seed=0), 8,
                    seed=0, class_sep=1.5)
    n_events = synthesize_updates(g, 40, seed=1).to_jsonl(path)
    res = serve_gnn.main(SMALL + ["--requests", "48", "--replicas", "2",
                                  "--router-policy", "round_robin",
                                  "--private-cache", "--reorder", "bfs",
                                  "--update-stream", path])
    assert res["served"] == 48 and res["all_logits_finite"]
    assert res["update_seq"] == n_events
    assert not res["shared_cache"]
    sent = [r.node_id for r in poisson_workload(48, np.arange(120), 2000.0,
                                                seed=1)]
    assert [r.node_id for r in res["responses"]] == sent
    assert res["forward_calls"] == res["router"].forward_calls > 0


@pytest.mark.parametrize("flag", [[], ["--replicas", "1"]])
def test_ckpt_dir_refused_under_a_single_replica(flag):
    with pytest.raises(SystemExit, match="--replicas > 1 or --autoscale"):
        serve_gnn.parse_args(["--device", "cpu", "--ckpt-dir", "ck"] + flag)


def test_cuda_device_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_gnn.main(["--nodes", "64", "--requests", "4"])
