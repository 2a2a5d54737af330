"""The port's other training samplers against the reference's, from the
same seed on the same graph: ``ImportanceSampler`` (PinSage-style),
``LayerWiseSampler`` (FastGCN and LADIES), ``bfs_clusters``,
``ClusterSampler`` and ``SaintRWSampler`` give the reference's blocks and
subgraphs bitwise, call after call (their generators carry on), and the
port's ``forward_blocks`` over the sampled blocks matches the
reference's within 1e-5 with the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as RSA
from repro.core.abstraction import DeviceGraph as RefDeviceGraph
from repro.graph import generators as RG
from repro.models.gnn import model as RGM
from repro_torch.core import sampling as SA
from repro_torch.core.abstraction import DeviceGraph
from repro_torch.graph import generators as G
from repro_torch.models.gnn import model as GM

BLOCK_FIELDS = ("src_nodes", "dst_nodes", "edge_src", "edge_dst",
                "edge_mask")


@pytest.fixture(scope="module")
def graphs():
    ref = RG.featurize(RG.sbm(144, 4, p_in=0.9, p_out=0.02, seed=0), 16,
                       seed=0, class_sep=1.5)
    port = G.featurize(G.sbm(144, 4, p_in=0.9, p_out=0.02, seed=0), 16,
                       seed=0, class_sep=1.5)
    return ref, port


# name -> (reference sampler, port sampler) from one constructor call
SAMPLERS = {
    "importance": lambda m, g: m.ImportanceSampler(g, [5, 5], seed=4),
    "importance_long_walks": lambda m, g: m.ImportanceSampler(
        g, [3, 4], walk_len=3, n_walks=5, seed=9),
    "fastgcn": lambda m, g: m.LayerWiseSampler(g, [32, 32],
                                               dependent=False, seed=4),
    "ladies": lambda m, g: m.LayerWiseSampler(g, [32, 32], dependent=True,
                                              seed=4),
    "ladies_three_layers": lambda m, g: m.LayerWiseSampler(
        g, [8, 16, 24], dependent=True, seed=2),
}


def _assert_minibatch_equal(mp, mr):
    assert len(mp.blocks) == len(mr.blocks)
    for bp, br in zip(mp.blocks, mr.blocks):
        for f in BLOCK_FIELDS:
            a, b = getattr(bp, f), getattr(br, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(mp.seeds, mr.seeds)
    np.testing.assert_array_equal(mp.input_nodes, mr.input_nodes)


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_gives_the_reference_blocks(graphs, name):
    ref_g, g = graphs
    ref, port = SAMPLERS[name](RSA, ref_g), SAMPLERS[name](SA, g)
    assert port.name == ref.name
    rng = np.random.default_rng(3)
    for _ in range(3):                    # the generator state carries on
        seeds = rng.choice(144, 16, replace=False)
        _assert_minibatch_equal(port.sample(seeds), ref.sample(seeds))


def test_layerwise_blocks_change_their_edge_count(graphs):
    """A layer-wise block holds exactly the edges between its picked
    nodes and its destinations: E differs from batch to batch (the
    kernels meet a new shape each step)."""
    _, g = graphs
    s = SA.LayerWiseSampler(g, [32, 32], dependent=True, seed=4)
    rng = np.random.default_rng(0)
    counts = {len(s.sample(rng.choice(144, 16, replace=False)).blocks[0]
                  .edge_mask) for _ in range(6)}
    assert len(counts) > 1


@pytest.mark.parametrize("n_clusters", [4, 7])
def test_bfs_clusters_equal_reference(graphs, n_clusters):
    ref_g, g = graphs
    got = SA.bfs_clusters(g, n_clusters, seed=5)
    np.testing.assert_array_equal(got, RSA.bfs_clusters(ref_g, n_clusters,
                                                        seed=5))
    assert set(got.tolist()) <= set(range(n_clusters))


@pytest.mark.parametrize("name", ["cluster", "saint_rw"])
def test_subgraph_sampler_equals_reference(graphs, name):
    ref_g, g = graphs
    if name == "cluster":
        ref, port = (m.ClusterSampler(gr, 6, 2, seed=1)
                     for m, gr in ((RSA, ref_g), (SA, g)))
        np.testing.assert_array_equal(port.assign, ref.assign)
    else:
        ref, port = (m.SaintRWSampler(gr, 12, 4, seed=1)
                     for m, gr in ((RSA, ref_g), (SA, g)))
    assert port.name == ref.name
    for _ in range(3):
        (nodes, sub), (ref_nodes, ref_sub) = (port.sample_subgraph(),
                                              ref.sample_subgraph())
        np.testing.assert_array_equal(nodes, ref_nodes)
        for f in ("row_ptr", "col_idx", "features", "labels"):
            np.testing.assert_array_equal(getattr(sub, f),
                                          getattr(ref_sub, f))


@pytest.mark.parametrize("arch", ["sage", "gcn"])
@pytest.mark.parametrize("name", ["importance", "fastgcn", "ladies"])
def test_forward_blocks_matches_reference(graphs, name, arch):
    ref_g, g = graphs
    kw = dict(arch=arch, feat_dim=16, hidden=32, num_classes=4)
    ref_cfg, cfg = RGM.GNNConfig(**kw), GM.GNNConfig(**kw)
    params = RGM.init_gnn(ref_cfg, jax.random.PRNGKey(1))
    model = GM.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    seeds = np.random.default_rng(8).choice(144, 24, replace=False)
    mb = SAMPLERS[name](SA, g).sample(seeds)
    ref_mb = SAMPLERS[name](RSA, ref_g).sample(seeds)
    ids = mb.input_nodes
    x = np.where((ids >= 0)[:, None], g.features[np.maximum(ids, 0)], 0.0
                 ).astype(np.float32)
    with torch.no_grad():
        got = GM.forward_blocks(cfg, model, [DeviceGraph.from_block(
            b, "cpu") for b in mb.blocks], torch.from_numpy(x)).numpy()
    want = RGM.forward_blocks(ref_cfg, params, [RefDeviceGraph.from_block(b)
                                                for b in ref_mb.blocks],
                              jnp.asarray(x))
    assert got.shape == (24, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
