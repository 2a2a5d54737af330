"""The port's host-side distributed layer against the reference, integer
for integer: the partitioners and their quality metrics, ``contiguousize``,
``shard_graph`` / ``push_layout``, the synchronization policies, the halo
layout and the staleness-bounded refresh plans of ``HaloExchange``
(versions, masks, bytes), with a graph-delta invalidation in between.

All numpy, in-process: no world is spawned here.  Sizes are the reference's
check sizes (``sbm(144, 4)`` and ``sbm(192, 4)``, 16 features)."""
import numpy as np
import pytest
import torch

from repro.core import halo as ref_halo
from repro.core import partitioning as ref_part
from repro.core import propagation as ref_prop
from repro.core import sync as ref_sync
from repro.graph import generators as RG
from repro_torch.core import halo, partitioning, propagation, sync
from repro_torch.graph import generators as G

PARTITIONERS = ["hash", "ldg", "fennel", "hdrf", "hybrid", "2ps"]
EDGE_CUT = ["hash", "ldg", "fennel"]


@pytest.fixture(scope="module", params=[144, 192])
def graphs(request):
    n = request.param
    ref = RG.featurize(RG.sbm(n, 4, p_in=0.9, p_out=0.02, seed=0), 16,
                       seed=0, class_sep=1.5)
    port = G.featurize(G.sbm(n, 4, p_in=0.9, p_out=0.02, seed=0), 16,
                       seed=0, class_sep=1.5)
    np.testing.assert_array_equal(port.edges(), ref.edges())
    return ref, port


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("method", PARTITIONERS)
def test_partitioners_assign_as_the_reference(graphs, method, parts):
    ref_g, g = graphs
    want = ref_part.partition(ref_g, parts, method)
    got = partitioning.partition(g, parts, method)
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, ref_part.EdgeCutPartition):
        np.testing.assert_array_equal(got.assignment, want.assignment)
        assert got.edge_cut_fraction(g) == want.edge_cut_fraction(ref_g)
    else:
        np.testing.assert_array_equal(got.edge_assignment,
                                      want.edge_assignment)
    assert got.balance() == want.balance()
    assert got.replication_factor(g) == want.replication_factor(ref_g)


def test_grid_and_selection_as_the_reference(graphs):
    ref_g, g = graphs
    np.testing.assert_array_equal(
        partitioning.grid_vertex_cut(g, 4).edge_assignment,
        ref_part.grid_vertex_cut(ref_g, 4).edge_assignment)
    with pytest.raises(ValueError, match="square"):
        partitioning.grid_vertex_cut(g, 2)
    for parts in (2, 4, 64):
        for budget in (1.0, 1e-6):
            assert partitioning.select_partitioner(
                g, parts, latency_budget_s=budget) == \
                ref_part.select_partitioner(ref_g, parts,
                                            latency_budget_s=budget)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("method", EDGE_CUT)
def test_shard_graph_and_push_layout_as_the_reference(graphs, method,
                                                      parts):
    ref_g, g = graphs
    order, counts = partitioning.contiguousize(
        g, partitioning.partition(g, parts, method))
    r_order, r_counts = ref_part.contiguousize(
        ref_g, ref_part.partition(ref_g, parts, method))
    np.testing.assert_array_equal(order, r_order)
    np.testing.assert_array_equal(counts, r_counts)
    sg = propagation.shard_graph(g, parts, method=method)
    ref = ref_prop.shard_graph(ref_g, parts, method=method)
    assert (sg.n_dev, sg.n_local, sg.e_local) == (ref.n_dev, ref.n_local,
                                                  ref.e_local)
    for name in ("perm", "edge_src_g", "edge_dst_l", "edge_mask", "x",
                 "labels", "label_mask", "in_deg", "out_deg"):
        a, b = getattr(sg, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    push, ref_push = (propagation.push_layout(sg, g),
                      ref_prop.push_layout(ref, ref_g))
    for name in ("edge_src_l", "edge_dst_g", "edge_mask"):
        np.testing.assert_array_equal(push[name],
                                      np.asarray(ref_push[name]))


@pytest.mark.parametrize("push", [False, True])
def test_rank_shard_coefficients_come_from_the_global_degrees(graphs, push):
    """The rank's ``DeviceGraph`` counts only its own edges; the GCN
    coefficient must be the global one."""
    _, g = graphs
    sg = propagation.shard_graph(g, 4)
    arrays = propagation.push_layout(sg, g) if push else None
    for rank in range(4):
        sh = propagation.rank_shard(sg, rank, "cpu", push_arrays=arrays)
        src = sh.graph.edge_src.long().numpy()
        dst = sh.graph.edge_dst.long().numpy()
        if push:
            src = src + rank * sg.n_local
        else:
            dst = dst + rank * sg.n_local
        want = 1 / np.sqrt(sg.out_deg[src]) / np.sqrt(sg.in_deg[dst])
        np.testing.assert_allclose(sh.coef.numpy(), want, rtol=1e-6)
        assert (sh.graph.num_src, sh.graph.num_dst) == (
            (sg.n_local, sg.n_pad) if push else (sg.n_pad, sg.n_local))
        own = slice(rank * sg.n_local, (rank + 1) * sg.n_local)
        np.testing.assert_array_equal(sh.x.numpy(), sg.x[own])
        # the DeviceGraph's own degrees (this rank's edges only) would
        # give another coefficient
        if push:
            local = sh.graph.in_deg.numpy()[sh.graph.edge_dst.long().numpy()]
            assert (local != sg.in_deg[dst]).any()
        else:
            local = sh.graph.out_deg.numpy()[sh.graph.edge_src.long().numpy()]
            assert (local != sg.out_deg[src]).any()


def test_sync_policies_as_the_reference():
    for mode, s in (("bsp", 1), ("stale", 3), ("bounded", 2)):
        a, b = sync.SyncPolicy(mode, s), ref_sync.SyncPolicy(mode, s)
        assert [a.needs_refresh(t) for t in range(12)] == \
            [b.needs_refresh(t) for t in range(12)]
    losses = [2.0, 1.5, 1.2, 1.1, 1.09, 1.089, 1.0889, 1.5, 1.4]
    a, b = sync.HysyncController(stale_s=3), ref_sync.HysyncController(
        stale_s=3)
    assert [(a.observe(t, x), a.staleness()) for t, x in enumerate(losses)] \
        == [(b.observe(t, x), b.staleness()) for t, x in enumerate(losses)]
    assert a.switch_step == b.switch_step is not None
    ca, cb = sync.HaloCache("x0"), ref_sync.HaloCache("x0")
    pol = sync.SyncPolicy("stale", 3)
    seq = [ca.maybe_refresh(pol, t, f"x{t}") for t in range(10)]
    assert seq == [cb.maybe_refresh(pol, t, f"x{t}") for t in range(10)]
    assert ca.comm_savings() == cb.comm_savings()


@pytest.mark.parametrize("method", EDGE_CUT)
def test_halo_layout_as_the_reference(graphs, method):
    ref_g, g = graphs
    lay = halo.build_halo(g, partitioning.partition(g, 4, method))
    ref = ref_halo.build_halo(ref_g, ref_part.partition(ref_g, 4, method))
    for name in ("owner", "halo_idx", "halo_mask"):
        np.testing.assert_array_equal(getattr(lay, name), getattr(ref, name))
    for name in ("owned", "halo_in", "halo_out", "halo"):
        for a, b in zip(getattr(lay, name), getattr(ref, name)):
            np.testing.assert_array_equal(a, b)
    assert lay.ghost_fraction() == ref.ghost_fraction()
    assert lay.exchange_bytes(64) == ref.exchange_bytes(64)
    np.testing.assert_array_equal(lay.gather_halo(g.features),
                                  ref.gather_halo(ref_g.features))


@pytest.mark.parametrize("codec", ["fp32", "int8"])
@pytest.mark.parametrize("frac", [0.0, 0.1])
@pytest.mark.parametrize("staleness", [0, 1, 4])
def test_refresh_plans_as_the_reference(graphs, staleness, frac, codec):
    """Plans over the relabelled padded rows of a 4-rank ``ShardedGraph``:
    the same masks, rows, bytes and versions step for step, and after a
    graph-delta invalidation of some rows."""
    ref_g, g = graphs
    sg = propagation.shard_graph(g, 4)
    part = partitioning.EdgeCutPartition((sg.perm // sg.n_local), 4)
    r_part = ref_part.EdgeCutPartition((sg.perm // sg.n_local), 4)
    kw = dict(max_staleness=staleness, refresh_frac=frac, relabel=sg.perm,
              n_rows=sg.n_pad, codec=codec)
    ex = halo.HaloExchange(halo.build_halo(g, part), [32, 8], **kw)
    ref = ref_halo.HaloExchange(ref_halo.build_halo(ref_g, r_part), [32, 8],
                                **kw)
    assert ex.n_ghost == ref.n_ghost
    assert ex.sync_bytes_per_step() == ref.sync_bytes_per_step()
    for t in range(9):
        if t == 5:
            rows = sg.perm[:40:3]
            assert ex.invalidate_rows(rows) == ref.invalidate_rows(rows)
        a, b = ex.plan_refresh(), ref.plan_refresh()
        assert (a.step, a.rows_moved, a.payload_bytes, a.header_bytes) == \
            (b.step, b.rows_moved, b.payload_bytes, b.header_bytes)
        for ma, mb in zip(a.masks, b.masks):
            np.testing.assert_array_equal(ma, mb)
        for ba, bb in zip(ex.buffers, ref.buffers):
            np.testing.assert_array_equal(ba.version, bb.version)
    assert ex.stats() == ref.stats()


def test_ghost_planes_live_on_the_device_and_take_only_refreshed_rows():
    g = G.featurize(G.sbm(144, 4, p_in=0.9, p_out=0.02, seed=0), 16, seed=0)
    sg = propagation.shard_graph(g, 2)
    part = partitioning.EdgeCutPartition(sg.perm // sg.n_local, 2)
    ex = halo.HaloExchange(halo.build_halo(g, part), [8], max_staleness=1,
                           relabel=sg.perm, n_rows=sg.n_pad)
    before = ex.ghost_planes()[0].clone()
    assert isinstance(before, torch.Tensor)
    plan = ex.plan_refresh()
    plane = torch.arange(sg.n_pad * 8, dtype=torch.float32).reshape(-1, 8)
    ex.write_planes(plan, [plane])
    after = ex.ghost_planes()[0]
    m = torch.from_numpy(plan.masks[0])
    assert torch.equal(after[m], plane[m])
    assert torch.equal(after[~m], before[~m])
    assert int(m.sum()) == ex.n_ghost
