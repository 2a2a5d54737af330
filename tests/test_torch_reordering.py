"""The port's locality reordering (``repro_torch.core.reordering``)
against the reference's, on the same numpy graphs: every policy's
``perm`` bitwise (ties break through stable sorts and the CSR neighbour
order), the packed graph's arrays, the three locality metrics, the
``perm``/``inv`` round trip, and the forward on a packed graph: mapped
back through ``perm`` it matches the unpacked forward, and it matches the
reference's forward on the same packed graph with the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reordering as RRO
from repro.core.abstraction import DeviceGraph as RefDeviceGraph
from repro.graph import generators as RG
from repro.graph import structure as RS
from repro.models.gnn import model as RGM
from repro_torch.core import reordering as RO
from repro_torch.core.abstraction import DeviceGraph
from repro_torch.graph import generators as G
from repro_torch.graph import structure as S
from repro_torch.models.gnn import model as GM

TOL = dict(rtol=1e-5, atol=1e-5)
GRAPHS = ["sbm", "ba", "grid", "chain", "edgeless"]


def _make(name, gen, struct):
    """The same graph from either package (the port's generators and
    structure are copies: bit-identical)."""
    if name == "sbm":
        g = gen.sbm(160, 4, p_in=0.9, p_out=0.02, seed=3)
        return gen.featurize(g, 12, seed=3, class_sep=1.5)
    if name == "ba":
        return gen.featurize(gen.barabasi_albert(150, 3, seed=1), 8,
                             seed=1, num_classes=5)
    if name == "grid":
        return gen.grid2d(7, 9)
    if name == "chain":
        # a path with scrambled labels: RCM recovers bandwidth 1
        rel = np.random.default_rng(4).permutation(40)
        e = np.stack([rel[:-1], rel[1:]], 1)
        return struct.make_undirected(40, e)
    return struct.from_edges(20, np.zeros((0, 2), np.int64),
                             features=np.arange(40, dtype=np.float32
                                                ).reshape(20, 2),
                             labels=np.arange(20, dtype=np.int32) % 3,
                             num_classes=3)


@pytest.fixture(scope="module")
def graphs():
    return {n: (_make(n, RG, RS), _make(n, G, S)) for n in GRAPHS}


@pytest.mark.parametrize("policy", sorted(RRO.REORDER_POLICIES))
@pytest.mark.parametrize("name", GRAPHS)
def test_perm_equals_reference_bitwise(graphs, name, policy):
    ref_g, g = graphs[name]
    want = RRO.REORDER_POLICIES[policy](ref_g)
    got = RO.REORDER_POLICIES[policy](g)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    _, perm, inv = RO.reorder_graph(g, policy)
    _, ref_perm, ref_inv = RRO.reorder_graph(ref_g, policy)
    np.testing.assert_array_equal(perm, ref_perm)
    np.testing.assert_array_equal(inv, ref_inv)


def test_legacy_aliases_equal_reference(graphs):
    ref_g, g = graphs["sbm"]
    assert sorted(RO.REORDERINGS) == sorted(RRO.REORDERINGS)
    for key, fn in RO.REORDERINGS.items():
        np.testing.assert_array_equal(fn(g), RRO.REORDERINGS[key](ref_g))


@pytest.mark.parametrize("policy", sorted(RRO.REORDER_POLICIES))
@pytest.mark.parametrize("name", GRAPHS)
def test_packed_graph_equals_reference(graphs, name, policy):
    ref_g, g = graphs[name]
    ref_p, _, _ = RRO.reorder_graph(ref_g, policy)
    got, _, _ = g.reordered(policy)
    np.testing.assert_array_equal(got.row_ptr, ref_p.row_ptr)
    np.testing.assert_array_equal(got.col_idx, ref_p.col_idx)
    assert got.col_idx.dtype == ref_p.col_idx.dtype
    for field in ("features", "labels"):
        a, b = getattr(got, field), getattr(ref_p, field)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert got.num_classes == ref_p.num_classes
    if policy == "none":
        assert got is g                     # unchanged, identity maps


@pytest.mark.parametrize("policy", sorted(RRO.REORDER_POLICIES))
@pytest.mark.parametrize("name", GRAPHS)
def test_locality_metrics_equal_reference(graphs, name, policy):
    ref_g, g = graphs[name]
    ref_p, _, _ = RRO.reorder_graph(ref_g, policy)
    got, _, _ = RO.reorder_graph(g, policy)
    assert RO.locality_report(got) == RRO.locality_report(ref_p)
    kw = dict(window=8, reuse_window=16)
    assert RO.locality_report(got, **kw) == RRO.locality_report(ref_p, **kw)
    assert RO.edge_locality(got, window=3) == RRO.edge_locality(ref_p,
                                                                window=3)
    assert RO.reuse_distance_hit_rate(got, window=5) == \
        RRO.reuse_distance_hit_rate(ref_p, window=5)


def test_rcm_recovers_the_chain(graphs):
    _, g = graphs["chain"]
    packed, _, _ = RO.reorder_graph(g, "rcm")
    e = packed.edges()
    assert int(np.abs(e[:, 0] - e[:, 1]).max()) == 1


def test_unknown_policy_raises_key_error(graphs):
    _, g = graphs["sbm"]
    with pytest.raises(KeyError, match="unknown reorder policy"):
        RO.reorder_graph(g, "metis")
    with pytest.raises(KeyError):
        g.reordered("random")


@pytest.mark.parametrize("policy", sorted(RRO.REORDER_POLICIES))
def test_perm_inv_round_trip(graphs, policy):
    _, g = graphs["sbm"]
    packed, perm, inv = g.reordered(policy)
    n = g.num_nodes
    np.testing.assert_array_equal(perm[inv], np.arange(n))
    np.testing.assert_array_equal(inv[perm], np.arange(n))
    # packed node i is original node perm[i]: rows and edges agree
    np.testing.assert_array_equal(packed.features, g.features[perm])
    np.testing.assert_array_equal(packed.labels, g.labels[perm])
    pe = packed.edges()
    back = np.stack([perm[pe[:, 0]], perm[pe[:, 1]]], 1)
    ge = g.edges()
    key = lambda e: e[np.lexsort((e[:, 1], e[:, 0]))]   # noqa: E731
    np.testing.assert_array_equal(key(back), key(ge))


@pytest.mark.parametrize("policy", ["degree", "bfs", "rcm"])
@pytest.mark.parametrize("arch", ["gcn", "sage", "gat", "gin"])
def test_forward_on_packed_graph(graphs, arch, policy):
    """The port's forward over the packed graph, mapped back through
    ``perm``, is the unpacked forward; and it is the reference's forward
    over the same packed graph with the same weights."""
    ref_g, g = graphs["sbm"]
    kw = dict(arch=arch, feat_dim=12, hidden=16, num_classes=4)
    ref_cfg, cfg = RGM.GNNConfig(**kw), GM.GNNConfig(**kw)
    params = RGM.init_gnn(ref_cfg, jax.random.PRNGKey(7))
    model = GM.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    packed, perm, inv = RO.reorder_graph(g, policy)
    ref_packed, _, _ = RRO.reorder_graph(ref_g, policy)

    def port(gr):
        with torch.no_grad():
            return GM.forward_full(cfg, model, DeviceGraph.from_graph(
                gr, "cpu"), torch.from_numpy(gr.features)).numpy()

    out_packed = port(packed)
    want = np.asarray(RGM.forward_full(
        ref_cfg, params, RefDeviceGraph.from_graph(ref_packed),
        jnp.asarray(ref_packed.features)))
    tol = dict(TOL)
    if arch == "gin":
        # GIN's sums are unnormalized (outputs reach 2e2 here): float32
        # sums in another order are held to 1e-5 of the largest output,
        # as its one-step gradients are in test_torch_train.py
        tol["atol"] = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(out_packed[inv], port(g), **tol)
    np.testing.assert_allclose(out_packed, want, **tol)
