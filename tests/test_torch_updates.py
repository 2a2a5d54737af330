"""The port's streaming graph updates (``repro_torch.core.updates``) and
the delta hooks of its serving stack, against the reference's, as the
single-device tests of ``tests/test_dynamic_graph.py`` hold the
reference: log sequencing and clock stamps, ``apply`` bitwise (one shot
and composed), ``delta``, ``k_hop_nodes``, the JSONL wire format read by
the other package's loader both ways, ``fold_in_place``, the serving
sampler's ``apply_delta`` / ``affected_seed_mask``, the cache's
``invalidate_rows``, the server's delta fold against a cold rebuild (and
against the reference's server) within 1e-5, a feature update reaching
the next batch's rows, and fold commuting with relabelling."""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.core import reordering as RRO
from repro.core import updates as RU
from repro.graph import generators as RG
from repro.models.gnn import model as RGM
from repro.serving import GNNInferenceServer as RefServer
from repro.serving.batcher import MicroBatch as RefMicroBatch
from repro.serving.cache import EmbeddingCache as RefCache
from repro.serving.sampler import ServingSampler as RefSampler
from repro_torch.core import reordering as RO
from repro_torch.core import telemetry
from repro_torch.core import updates as U
from repro_torch.core.caching import VersionClock
from repro_torch.graph import generators as G
from repro_torch.models.gnn import model as GM
from repro_torch.serving import GNNInferenceServer, poisson_workload
from repro_torch.serving.batcher import MicroBatch
from repro_torch.serving.cache import NEVER, EmbeddingCache
from repro_torch.serving.sampler import ServingSampler

NODES = 144


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(gen, n=NODES, seed=0):
    g = gen.sbm(n, 4, p_in=0.9, p_out=0.02, seed=seed)
    return gen.featurize(g, 16, seed=seed, class_sep=1.5)


@pytest.fixture()
def pair():
    """The same graph and 16-event stream from both packages (private
    copies: the folds below mutate them)."""
    ref_g, g = _graph(RG), _graph(G)
    return (ref_g, RU.synthesize_updates(ref_g, 16, seed=2),
            g, U.synthesize_updates(g, 16, seed=2))


def _events(log):
    return [(e.seq, e.kind, e.u, e.v, e.clock,
             None if e.x is None else e.x.tolist()) for e in log.events]


def _assert_graph_equal(a, b):
    for f in ("row_ptr", "col_idx", "features", "labels"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.num_classes == b.num_classes


def _crafted(mod, clock=None):
    """Duplicates, a removal of an absent pair, a re-add after a removal,
    a removal naming dst -1, feature events on one node twice."""
    log = mod.GraphUpdateLog(clock=clock)
    log.add_edge(1, 2)
    log.add_edge(1, 2)
    log.remove_edge(7, 8)
    log.update_features(3, np.full(16, 0.5))
    log.remove_edge(1, 2)
    log.add_edge(1, 2)
    log.remove_edge(5, -1)
    log.add_edge(0, 143)
    log.update_features(3, np.arange(16))
    log.remove_edge(0, 143)
    log.add_edge(143, 0)
    return log


def test_synthesized_stream_equals_reference(pair):
    ref_g, ref_log, g, log = pair
    assert _events(log) == _events(ref_log)
    assert log.counts == ref_log.counts and log.stats() == ref_log.stats()


def test_log_append_sequencing_and_clock_stamps():
    clock = VersionClock()
    log = U.GraphUpdateLog(clock=clock)
    e1 = log.add_edge(0, 1)
    clock.tick(3)
    e2 = log.remove_edge(0, 1)
    e3 = log.update_features(2, np.ones(4))
    assert (e1.seq, e2.seq, e3.seq) == (1, 2, 3)
    assert e1.clock == 0 and e2.clock == 3 and e3.clock == 3
    assert log.last_seq == 3
    assert log.counts == {"add_edge": 1, "remove_edge": 1,
                          "update_features": 1}
    assert e3.x.dtype == np.float32
    assert _events(log) == _events(_mirror(log))


def _mirror(log):
    """The reference's log with the same events appended."""
    ref = RU.GraphUpdateLog()
    for e in log.events:
        if e.kind == "update_features":
            ref.update_features(e.u, e.x)
        else:
            getattr(ref, e.kind)(e.u, e.v)
    ref.clock.now = 0
    for a, b in zip(ref.events, log.events):
        object.__setattr__(a, "clock", b.clock)
    return ref


@pytest.mark.parametrize("stream", ["synthesized", "long", "crafted"])
def test_apply_equals_reference_bitwise(stream):
    ref_g, g = _graph(RG), _graph(G)
    if stream == "crafted":
        ref_log, log = _crafted(RU), _crafted(U)
    else:
        n = 16 if stream == "synthesized" else 400
        ref_log = RU.synthesize_updates(ref_g, n, seed=5)
        log = U.synthesize_updates(g, n, seed=5)
    last = log.last_seq
    for a, b in [(0, None), (0, last // 3), (last // 3, None),
                 (last // 3, 2 * last // 3)]:
        want = ref_log.apply(ref_log.apply(ref_g, a) if a else ref_g, b,
                             from_seq=a)
        got = log.apply(log.apply(g, a) if a else g, b, from_seq=a)
        _assert_graph_equal(got, want)
    # composition: two folds are the one-shot fold, bitwise
    s1 = last // 2
    _assert_graph_equal(log.apply(log.apply(g, s1), from_seq=s1),
                        log.apply(g))


def test_apply_never_mutates_the_input(pair):
    _, _, g, log = pair
    before = copy.deepcopy(g)
    log.apply(g)
    _assert_graph_equal(g, before)


def test_remove_edge_drops_all_copies_and_is_lenient():
    g = G.featurize(G.sbm(20, 2, p_in=0.0, p_out=0.0, seed=0), 4, seed=0)
    log = U.GraphUpdateLog()
    for _ in range(3):
        log.add_edge(0, 1)
    log.remove_edge(0, 1)
    log.remove_edge(5, 6)                  # absent: no-op
    log.add_edge(0, 1)
    out = log.apply(g)
    assert out.num_edges == 1 and list(out.neighbors(0)) == [1]


@pytest.mark.parametrize("bad", ["range_u", "range_v", "dst", "shape",
                                 "seq"])
def test_apply_rejects_what_the_reference_rejects(bad):
    outs = []
    for mod, gen in ((RU, RG), (U, G)):
        g = _graph(gen)
        log = mod.GraphUpdateLog()
        log.add_edge(0, 1)
        if bad == "range_u":
            log.add_edge(NODES, 1)
        elif bad == "range_v":
            log.remove_edge(1, NODES + 3)
        elif bad == "dst":
            log.add_edge(2, -1)
        elif bad == "shape":
            log.update_features(1, np.ones(5))
        with pytest.raises(ValueError) as exc:
            if bad == "seq":
                log.apply(g, 5)
            else:
                log.apply(g)
        outs.append(str(exc.value))
    assert outs[0] == outs[1]


def test_delta_equals_reference(pair):
    _, ref_log, _, log = pair
    for a, b in [(0, None), (0, 5), (5, 11), (11, 16), (16, 16)]:
        got, want = log.delta(a, b), ref_log.delta(a, b)
        assert (got.from_seq, got.to_seq, got.n_events) == \
            (want.from_seq, want.to_seq, want.n_events)
        np.testing.assert_array_equal(got.nodes, want.nodes)
        np.testing.assert_array_equal(got.edges, want.edges)
        assert got.edges.shape[1] == 2


@pytest.mark.parametrize("hops", [0, 1, 2, 3])
def test_k_hop_nodes_equal_reference(pair, hops):
    ref_g, _, g, _ = pair
    seeds = np.array([3, 40, 77])
    np.testing.assert_array_equal(U.k_hop_nodes(g, seeds, hops),
                                  RU.k_hop_nodes(ref_g, seeds, hops))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_jsonl_round_trip_across_packages(tmp_path, pair, writer):
    ref_g, ref_log, g, log = pair
    path = str(tmp_path / "u.jsonl")
    src, reader = (log, RU) if writer == "port" else (ref_log, U)
    assert src.to_jsonl(path) == 16
    back = reader.load_update_stream(path)
    assert [e[:4] for e in _events(back)] == [e[:4] for e in _events(src)]
    for a, b in zip(back.events, src.events):
        if a.x is not None:
            np.testing.assert_array_equal(a.x, b.x)
    if writer == "port":
        _assert_graph_equal(log.apply(g), back.apply(ref_g))
    else:
        _assert_graph_equal(back.apply(g), ref_log.apply(ref_g))


def test_unknown_kind_in_stream_raises(tmp_path):
    path = tmp_path / "u.jsonl"
    path.write_text('{"kind": "add_node", "u": 3}\n')
    with pytest.raises(ValueError, match="unknown update kind"):
        U.load_update_stream(str(path))


@pytest.mark.parametrize("hops", [0, 1, 2])
def test_fold_in_place_equals_reference(pair, hops):
    ref_g, ref_log, g, log = pair
    holder = {"g": g}                       # another holder of the object
    delta, frontier = U.fold_in_place(g, log, 0, 9, hops=hops)
    ref_delta, ref_frontier = RU.fold_in_place(ref_g, ref_log, 0, 9,
                                               hops=hops)
    np.testing.assert_array_equal(delta.nodes, ref_delta.nodes)
    np.testing.assert_array_equal(frontier, ref_frontier)
    _assert_graph_equal(g, ref_g)
    assert holder["g"] is g
    U.fold_in_place(g, log, 9, hops=hops)
    RU.fold_in_place(ref_g, ref_log, 9, hops=hops)
    _assert_graph_equal(g, ref_g)
    _assert_graph_equal(g, log.apply(_graph(G)))


def test_log_reset_stats_lockstep():
    telemetry.set_enabled(True)
    try:
        log = U.GraphUpdateLog()
        log.reset_stats()          # series are process-global: clean slate
        log.add_edge(0, 1)
        log.update_features(1, np.zeros(3))
        reg = telemetry.get_registry()
        assert reg.value("graph_updates_total", kind="add_edge") == 1
        log.reset_stats()
        assert log.counts["add_edge"] == 0
        assert reg.value("graph_updates_total", kind="add_edge") == 0
        assert log.last_seq == 2                 # events are state, kept
    finally:
        telemetry.set_enabled(False)


def test_relabel_equals_reference(pair):
    _, ref_log, _, log = pair
    inv = np.random.default_rng(1).permutation(NODES)
    got, want = log.relabel(inv), ref_log.relabel(inv)
    assert _events(got) == _events(want)
    assert got.counts == log.counts and got.clock is log.clock


def _blocks_equal(a, b):
    for x, y in zip(a.blocks, b.blocks):
        for f in ("src_nodes", "dst_nodes", "edge_src", "edge_dst",
                  "edge_mask"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_sampler_apply_delta_equals_reference_and_fresh(pair):
    ref_g, ref_log, g, log = pair
    inc, ref_inc = ServingSampler(g, [5, 5], seed=0), RefSampler(
        ref_g, [5, 5], seed=0)
    ids = np.arange(16)
    inc.sample(ids)
    ref_inc.sample(ids)
    n_memo = len(inc._memo)
    delta, _ = U.fold_in_place(g, log, 0, hops=0)
    ref_delta, _ = RU.fold_in_place(ref_g, ref_log, 0, hops=0)
    dropped = inc.apply_delta(delta.nodes)
    assert dropped == ref_inc.apply_delta(ref_delta.nodes)
    assert len(inc._memo) == n_memo - dropped
    fresh = ServingSampler(g, [5, 5], seed=0)
    got = inc.sample(ids)
    _blocks_equal(got, fresh.sample(ids))
    _blocks_equal(got, ref_inc.sample(ids))


def test_sampler_affected_seed_mask_equals_reference(pair):
    ref_g, ref_log, g, log = pair
    s, rs = ServingSampler(g, [5, 5], seed=0), RefSampler(ref_g, [5, 5],
                                                           seed=0)
    delta, _ = U.fold_in_place(g, log, 0, hops=0)
    RU.fold_in_place(ref_g, ref_log, 0, hops=0)
    s.apply_delta(delta.nodes)
    rs.apply_delta(delta.nodes)
    seeds = np.array([-1, 0, 1, 2, 3, 50, 100, 143])
    mask = s.affected_seed_mask(seeds, delta.nodes)
    np.testing.assert_array_equal(mask, rs.affected_seed_mask(
        seeds, delta.nodes))
    ball = set(U.k_hop_nodes(g, delta.nodes, 2))
    assert not mask[0]
    assert all(mask[i] == (int(sd) in ball)
               for i, sd in enumerate(seeds) if sd >= 0)


def test_cache_invalidate_rows_equals_reference():
    g, ref_g = _graph(G), _graph(RG)
    cache = EmbeddingCache(g, [8], policy="degree", max_staleness=4)
    ref = RefCache(ref_g, [8], policy="degree", max_staleness=4)
    ids = np.arange(32)
    for c in (cache, ref):
        c.store(0, ids, np.ones((32, 8), np.float32), np.ones(32, bool))
    touched = np.arange(10)
    assert cache.invalidate_rows(touched) == ref.invalidate_rows(touched)
    (_, fresh), (_, ref_fresh) = cache.lookup(0, ids), ref.lookup(0, ids)
    np.testing.assert_array_equal(fresh, ref_fresh)
    assert not fresh[:10].any() and fresh[10:].any()
    assert (cache.planes[0].version[cache.slot[touched][
        cache.slot[touched] >= 0]] == NEVER).all()
    outside = np.array([-3, NODES + 7])     # cost nothing, count nothing
    assert cache.invalidate_rows(outside) == ref.invalidate_rows(outside)
    assert cache.invalidated_rows == ref.invalidated_rows == 10
    assert cache.clock == ref.clock


def _models(arch="sage"):
    kw = dict(arch=arch, feat_dim=16, hidden=32, num_classes=4)
    ref_cfg = RGM.GNNConfig(**kw)
    params = RGM.init_gnn(ref_cfg, jax.random.PRNGKey(0))
    model = GM.params_from_numpy(GM.GNNConfig(**kw),
                                 jax.tree.map(np.asarray, params),
                                 device="cpu")
    return ref_cfg, GM.GNNConfig(**kw), params, model


def _serve_all(srv, mb_cls, n=NODES, bucket=16):
    out = []
    for start in range(0, n, bucket):
        ids = np.full(bucket, -1, np.int64)
        chunk = np.arange(start, min(start + bucket, n))
        ids[:len(chunk)] = chunk
        out.append(np.asarray(srv.serve_batch(mb_cls([], ids, bucket, 0.0))
                              )[:len(chunk)])
    return np.concatenate(out)


def test_server_delta_equals_cold_rebuild_and_reference(pair):
    ref_g, ref_log, g, log = pair
    ref_cfg, cfg, params, model = _models()
    kw = dict(fanouts=[5, 5], buckets=(1, 16), max_staleness=4, seed=0)
    srv = GNNInferenceServer(copy.deepcopy(g), cfg, model, **kw)
    ref_srv = RefServer(copy.deepcopy(ref_g), ref_cfg, params, **kw)
    for s in (srv, ref_srv):
        s.warmup()
        s.run(poisson_workload(32, np.arange(NODES), 2000.0, seed=1))
    info, ref_info = srv.apply_graph_update(log), \
        ref_srv.apply_graph_update(ref_log)
    assert info == ref_info and info["events"] == 16
    assert srv.apply_graph_update(log)["events"] == 0     # idempotent
    assert len(srv.folds) == 2 and srv.folds[0] == info
    cold = GNNInferenceServer(log.apply(g), cfg, model, **kw)
    cold.warmup()
    got = _serve_all(srv, MicroBatch)
    assert np.max(np.abs(got - _serve_all(cold, MicroBatch))) <= 1e-5
    assert np.max(np.abs(got - _serve_all(ref_srv, RefMicroBatch))) <= 1e-5


def test_server_flush_invalidates_every_admitted_row(pair):
    _, _, g, log = pair
    _, cfg, _, model = _models()
    srv = GNNInferenceServer(copy.deepcopy(g), cfg, model, fanouts=[5, 5],
                             buckets=(16,), cache_capacity=40, seed=0)
    info = srv.apply_graph_update(log, 4, flush=True)
    assert info["invalidated_rows"] == 40 and srv._update_seq == 4
    again = srv.apply_graph_update(log, 4, flush=True)   # no events, flush
    assert again["events"] == 0 and again["invalidated_rows"] == 40


def test_feature_update_reaches_the_next_batch():
    """The server reads feature rows from the host graph per batch: after
    a fold, the rows its forward receives are the new ones."""
    g = _graph(G)
    _, cfg, _, model = _models()
    srv = GNNInferenceServer(g, cfg, model, fanouts=[5, 5], buckets=(4,),
                             cache_policy="none", seed=0)
    seen = []
    forward = srv._forward

    def spy(p, inner, outer, x, ch, fm):
        seen.append(x.clone())
        return forward(p, inner, outer, x, ch, fm)
    srv._forward = spy
    ids = np.array([7, -1, -1, -1])
    before = srv.serve_batch(MicroBatch([], ids, 4, 0.0))
    log = U.GraphUpdateLog()
    row = np.arange(16, dtype=np.float32) * 0.25
    log.update_features(7, row)
    srv.apply_graph_update(log)
    after = srv.serve_batch(MicroBatch([], ids, 4, 0.0))
    np.testing.assert_array_equal(seen[-1][0].numpy(), row)  # dst prefix
    assert not np.array_equal(seen[0][0].numpy(), row)
    assert not np.allclose(before[0], after[0])
    cold = GNNInferenceServer(log.apply(_graph(G)), cfg, model,
                              fanouts=[5, 5], buckets=(4,),
                              cache_policy="none", seed=0)
    np.testing.assert_allclose(after[0], cold.serve_batch(
        MicroBatch([], ids, 4, 0.0))[0], rtol=1e-6, atol=1e-6)


def test_run_folds_the_stream_between_batches(pair):
    _, _, g, log = pair
    _, cfg, _, model = _models()
    srv = GNNInferenceServer(copy.deepcopy(g), cfg, model, fanouts=[5, 5],
                             buckets=(1, 4, 16), seed=0)
    srv.warmup()
    stats = srv.run(poisson_workload(40, np.arange(NODES), 2000.0, seed=2),
                    update_log=log, update_every=10, update_chunk=5)
    assert stats.served == 40 and srv._update_seq == 16
    assert sum(f["events"] for f in srv.folds) == 16
    assert all(f["events"] <= 5 for f in srv.folds)
    _assert_graph_equal(srv.g, log.apply(g))


@pytest.mark.parametrize("policy", ["degree", "bfs", "rcm"])
def test_fold_commutes_with_relabeling(pair, policy):
    ref_g, ref_log, g, log = pair
    packed, perm, inv = RO.reorder_graph(g, policy)
    a = RO.apply_order(log.apply(g), perm)         # fold, then reorder
    b = log.relabel(inv).apply(packed)             # reorder, then fold

    def canon(gr):
        e = gr.edges()
        return e[np.lexsort((e[:, 1], e[:, 0]))]

    np.testing.assert_array_equal(canon(a), canon(b))
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.labels, b.labels)
    ref_packed, _, ref_inv = RRO.reorder_graph(ref_g, policy)
    _assert_graph_equal(b, ref_log.relabel(ref_inv).apply(ref_packed))
