"""Each GNN architecture of the port against the reference: the JAX
``init_gnn`` weights go through ``params_from_numpy``, and both packages
run ``forward_blocks`` / ``forward_blocks_cached`` (``forward_full`` for
APPNP, which is full-graph only) on the same numpy blocks and features.
Tolerance 1e-5: fp32 matmuls and sums in a different order.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.abstraction import DeviceGraph as RefDeviceGraph
from repro.graph import generators as RG
from repro.models.gnn import model as RGM
from repro.serving.sampler import ServingSampler
from repro_torch.core.abstraction import DeviceGraph
from repro_torch.models.gnn import model as GM

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["gcn", "sage", "gat", "gin", "ggnn"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker
    avoids oversubscribing the cores the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    g = RG.sbm(200, 4, p_in=0.9, p_out=0.02, seed=3)
    return RG.featurize(g, 12, seed=3, class_sep=1.5)


@pytest.fixture(scope="module")
def sparse_graph():
    """Average in-degree about 6, so unnormalized full-graph sums (GIN)
    stay at magnitudes where 1e-5 is a meaningful bound."""
    g = RG.sbm(200, 4, p_in=0.1, p_out=0.01, seed=4)
    return RG.featurize(g, 12, seed=4, class_sep=1.5)


@pytest.fixture(scope="module")
def minibatch(graph):
    """Two padded sampled blocks for 16 seed slots (3 of them pads)."""
    seeds = np.full(16, -1, np.int64)
    seeds[:13] = np.random.default_rng(0).choice(graph.num_nodes, 13,
                                                 replace=False)
    mb = ServingSampler(graph, [4, 3], seed=1).sample(seeds)
    ids = mb.input_nodes
    x = np.where((ids >= 0)[:, None], graph.features[np.maximum(ids, 0)],
                 0.0).astype(np.float32)
    return mb.blocks, x


def _models(arch, graph):
    cfg = GM.GNNConfig(arch=arch, feat_dim=12, hidden=16,
                       num_classes=graph.num_classes, num_layers=2)
    ref_cfg = RGM.GNNConfig(arch=arch, feat_dim=12, hidden=16,
                            num_classes=graph.num_classes, num_layers=2)
    params = RGM.init_gnn(ref_cfg, jax.random.PRNGKey(7))
    params_np = jax.tree.map(np.asarray, params)
    return cfg, ref_cfg, params, GM.params_from_numpy(cfg, params_np,
                                                      device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_blocks_matches_reference(arch, graph, minibatch):
    blocks, x = minibatch
    cfg, ref_cfg, params, model = _models(arch, graph)
    ref = RGM.forward_blocks(ref_cfg, params,
                             [RefDeviceGraph.from_block(b) for b in blocks],
                             x)
    with torch.inference_mode():
        got = GM.forward_blocks(
            cfg, model, [DeviceGraph.from_block(b, "cpu") for b in blocks],
            torch.from_numpy(x))
    assert got.shape == (16, graph.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_blocks_cached_matches_reference(arch, graph, minibatch):
    blocks, x = minibatch
    cfg, ref_cfg, params, model = _models(arch, graph)
    rng = np.random.default_rng(11)
    n = blocks[-1].num_src
    cached = rng.standard_normal((n, 16)).astype(np.float32)
    fresh = rng.random(n) < 0.4
    ref_logits, ref_h = RGM.forward_blocks_cached(
        ref_cfg, params, [RefDeviceGraph.from_block(blocks[0])],
        RefDeviceGraph.from_block(blocks[1]), x, cached, fresh)
    with torch.inference_mode():
        logits, h = GM.forward_blocks_cached(
            cfg, model, [DeviceGraph.from_block(blocks[0], "cpu")],
            DeviceGraph.from_block(blocks[1], "cpu"), torch.from_numpy(x),
            torch.from_numpy(cached), torch.from_numpy(fresh))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)


@pytest.mark.parametrize("arch", ARCHS + ["appnp"])
def test_forward_full_matches_reference(arch, sparse_graph):
    g = sparse_graph
    cfg, ref_cfg, params, model = _models(arch, g)
    ref = RGM.forward_full(ref_cfg, params, RefDeviceGraph.from_graph(g),
                           g.features)
    with torch.inference_mode():
        got = GM.forward_full(cfg, model, DeviceGraph.from_graph(g, "cpu"),
                              torch.from_numpy(g.features))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_appnp_is_full_graph_only(graph, minibatch):
    blocks, x = minibatch
    cfg, ref_cfg, params, model = _models("appnp", graph)
    with pytest.raises(KeyError):          # the reference's own failure
        RGM.forward_blocks(ref_cfg, params,
                           [RefDeviceGraph.from_block(b) for b in blocks], x)
    with pytest.raises(ValueError, match="full-graph"):
        GM.forward_blocks(cfg, model,
                          [DeviceGraph.from_block(b, "cpu") for b in blocks],
                          torch.from_numpy(x))


def test_params_from_numpy_names_and_ggnn_proj():
    # feat_dim == hidden: layer 0 needs no projection, layer 1 does
    ref_cfg = RGM.GNNConfig(arch="ggnn", feat_dim=16, hidden=16,
                            num_classes=4)
    cfg = GM.GNNConfig(arch="ggnn", feat_dim=16, hidden=16, num_classes=4)
    params = RGM.init_gnn(ref_cfg, jax.random.PRNGKey(1))
    model = GM.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    names = [sorted(k for k, _ in layer.named_parameters())
             for layer in model]
    assert names == [["b", "u_zrh", "w_msg", "w_zrh"],
                     ["b", "proj", "u_zrh", "w_msg", "w_zrh"]]
    assert params[0]["proj"] is None and model[0].proj is None
    np.testing.assert_array_equal(model[1].proj.detach().numpy(),
                                  np.asarray(params[1]["proj"]))
    bad = jax.tree.map(np.asarray, params)
    bad[0] = dict(bad[0], extra=np.zeros(1, np.float32))
    with pytest.raises(ValueError):
        GM.params_from_numpy(cfg, bad, device="cpu")
