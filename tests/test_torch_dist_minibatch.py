"""The port's distributed mini-batch pipeline (``distributed/sampler.py``,
``distributed/pipeline.py``, ``train_gnn --devices N --minibatch``)
against the reference's, at ``tests/distributed_train_check.py``'s sizes:
worlds 2 and 4 × hash and ldg × GCN and SAGE, GIN and GAT at world 2 with
hash, 3 AdamW steps (GIN and GAT also 3 SGD steps) on the same global
seed batches.  Every partition's batch arrays (``collate``'s stacks,
seeds, block sources) bitwise equal; the traffic ``stats()`` exactly
equal, from one process and as the ranks' sum; each step's loss and
every parameter within 1e-5 (GIN's and GAT's parameters under SGD); every
rank's parameters bitwise equal.  In-process: the
seeds split exactly by owner, pad slots fetch zero rows and count no
traffic, ``apply_delta`` refreshes the global degrees, a vertex-cut
partitioner raises, ``collate``'s shapes are static across batches, and
a rank's own store (``parts=(r,)``) gives the batches and bytes of the
full sampler; the launcher runs ``--devices 2 --minibatch`` on the CPU.

The reference runs once for the file, in a subprocess with forced host
devices (``tests/torch_dist_reference.py minibatch``); each world is
spawned once, every case a job of it.
"""
import functools

import numpy as np
import pytest

import torch_dist_ranks as R
from repro_torch.core import partitioning as part_mod
from repro_torch.distributed import (DistributedMinibatchSampler, collate,
                                     device_blocks)
from repro_torch.distributed.sampler import COUNTERS
from repro_torch.graph.structure import from_edges
from repro_torch.launch import train_gnn
from test_torch_propagation import WORLD_TIMEOUT_S, reference

TOL = 1e-5
RUNS = [(w, m, a) for w in (2, 4) for m in ("hash", "ldg")
        for a in ("gcn", "sage")] + [(2, "hash", "gin"), (2, "hash", "gat")]
CASES = [(w, m, a, "adamw") for w, m, a in RUNS] + [
    (2, "hash", a, "sgd") for a in ("gin", "gat")]
# Adam divides each gradient element by its own running magnitude: GAT's
# a_dst has a gradient of exactly zero up to roundoff (a destination's
# softmax ignores its own term) and some of GIN's elements nearly cancel,
# so after 3 AdamW steps those elements point where roundoff did (3e-4
# and 6e-3 from the reference, the single-card port's too; ROADMAP.md,
# Queue 3), and the later losses follow them.  Their parameters and
# losses are held under SGD; under AdamW, the first loss (no Adam step
# taken yet).
ADAMW_PARAMS_UNHELD = ("gin", "gat")
CUTS = [(w, m) for w in (2, 4) for m in ("hash", "ldg")]
STATS = ("halo_hit_ratio", "cross_partition_bytes", "local_rows",
         "remote_requests", "ghost_fraction")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference("minibatch", tmp_path_factory)


def ref_params(ref, key, n_layers=2) -> list:
    out = []
    for i in range(n_layers):
        pre = f"{key}/{i}/"
        out.append({k[len(pre):]: ref[k] for k in ref if k.startswith(pre)})
    return out


def launcher_argv(codec: str) -> list:
    return ["--device", "cpu", "--devices", "2", "--minibatch", "--arch",
            "sage", "--nodes", "160", "--epochs", "2", "--batch", "32",
            "--feat-dim", "8", "--hidden", "16", "--wire-codec", codec]


@pytest.fixture(scope="module")
def worlds(ref):
    """Each world spawned once, every (partitioner, arch, optimizer) case
    a job of it; world 2 also runs the launcher's int8 job."""
    out = {}
    for world in (2, 4):
        cases = [c for c in CASES if c[0] == world]
        jobs = [functools.partial(
            R.minibatch_run, method=m, arch=a, opt=o,
            params0=ref_params(ref, f"mb/init/{a}")) for _, m, a, o in cases]
        if world == 2:
            cases.append("launcher_int8")
            jobs.append(launcher_argv("int8"))
        out.update(zip(cases, train_gnn.run_world(
            jobs, world=world, device="cpu", timeout_s=WORLD_TIMEOUT_S)))
    return out


@pytest.fixture(scope="module")
def graph():
    return R.graph()


def out_deg(g):
    return np.maximum(g.out_degree(), 1).astype(np.float32)


@pytest.mark.parametrize("world, method", CUTS)
def test_batches_match_the_reference_bitwise(worlds, ref, graph, world,
                                             method):
    """Rank r's batches are partition r's: stacked in rank order,
    ``collate`` gives the reference's arrays bit for bit."""
    res = worlds[(world, method, "gcn", "adamw")]
    key = f"mb/{world}/{method}"
    for t in range(R.MB_STEPS):
        batches = [r["batches"][t] for r in res["ranks"]]
        assert [b.part for b in batches] == list(range(world))
        arrays = collate(batches, out_deg(graph))
        for k, v in arrays.items():
            for l, a in enumerate(v if isinstance(v, tuple) else (v,)):
                want = ref[f"{key}/{t}/{k}/{l}"]
                assert a.dtype == want.dtype and np.array_equal(a, want), \
                    (t, k, l)
        for b in batches:
            assert np.array_equal(b.seeds, ref[f"{key}/{t}/seeds/{b.part}"])
            for l, blk in enumerate(b.blocks):
                assert np.array_equal(blk.src_nodes,
                                      ref[f"{key}/{t}/src/{b.part}/{l}"])


@pytest.mark.parametrize("world, method", CUTS)
def test_stats_match_the_reference_exactly(worlds, ref, graph, world,
                                           method):
    """From one process over every partition, and as the sum of the
    ranks' own stores' counters."""
    key = f"mb/{world}/{method}"
    want = {k: ref[f"{key}/stats/{k}"].item() for k in STATS}
    ds = R.minibatch_sampler(graph, world, method)
    for seeds in R.minibatch_seeds(graph.num_nodes):
        ds.sample_global(seeds)
    one = ds.stats()
    assert {k: one[k] for k in STATS} == want
    ranks = worlds[(world, method, "gcn", "adamw")]["ranks"]
    summed = {k: sum(r["counters"][k] for r in ranks) for k in COUNTERS}
    assert summed == ds.counters()
    from_ranks = ds.stats(summed)
    assert {k: from_ranks[k] for k in STATS} == want


@pytest.mark.parametrize("world, method, arch, opt", CASES)
def test_training_matches_the_reference(worlds, ref, world, method, arch,
                                        opt):
    res = worlds[(world, method, arch, opt)]
    key = f"mb/{world}/{method}/{arch}/{opt}"
    want = ref_params(ref, key)
    err = max(float(np.abs(res["params"][i][k] - want[i][k]).max())
              for i in range(2) for k in want[i])
    held = R.MB_STEPS
    if opt == "adamw" and arch in ADAMW_PARAMS_UNHELD:
        held = 1
    else:
        assert err <= TOL, f"{key}: parameters off by {err}"
    np.testing.assert_allclose(res["losses"][:held],
                               ref[f"{key}/losses"][:held], rtol=0, atol=TOL)
    first = res["ranks"][0]
    for r in res["ranks"]:
        assert r["losses"] == first["losses"]
        for i in range(2):
            for k in first["params"][i]:
                assert np.array_equal(r["params"][i][k],
                                      first["params"][i][k]), (key, i, k)


def test_seeds_split_exactly_by_owner(graph):
    ds = R.minibatch_sampler(graph, 4, "ldg")
    seeds = R.minibatch_seeds(graph.num_nodes)[0]
    parts = [ds.owned_seeds(p, seeds) for p in range(4)]
    assert sorted(np.concatenate(parts).tolist()) == sorted(seeds.tolist())
    for p, own in enumerate(parts):
        assert (ds.layout.owner[own] == p).all()
        b = ds.sample_partition(p, own)
        real = b.seeds >= 0
        assert np.array_equal(b.seeds[real], own)
        assert np.array_equal(b.label_mask, real.astype(np.float32))
        assert np.array_equal(b.labels[real], graph.labels[own])


def test_pad_slots_fetch_zero_rows_and_count_no_traffic(graph):
    """An all-padding batch reads nothing; a real one's rows are the
    features where needed and zero elsewhere."""
    ds = R.minibatch_sampler(graph, 2, "hash")
    empty = ds.sample_partition(0, np.zeros(0, np.int64))
    assert not empty.x_in.any() and not empty.label_mask.any()
    assert all(v == 0 for v in ds.counters().values())
    own = ds.owned_seeds(1, R.minibatch_seeds(graph.num_nodes)[0])[:5]
    b = ds.sample_partition(1, own)
    src = b.blocks[0].src_nodes
    got = np.abs(b.x_in).sum(1) > 0
    assert not got[src < 0].any()
    assert np.array_equal(b.x_in[got], graph.features[src[got]])
    c = ds.counters()
    assert c["local_rows"] + c["hits"] + c["misses"] == int(got.sum())


def test_apply_delta_refreshes_the_global_degrees(graph):
    import dataclasses
    g = dataclasses.replace(graph)
    ds = R.minibatch_sampler(g, 2, "hash")
    e = g.edges()
    keep = e[:, 0] != 0                  # node 0 loses its out-edges
    touched = np.unique(e[~keep].ravel())
    cut = from_edges(g.num_nodes, e[keep])
    g.row_ptr, g.col_idx = cut.row_ptr, cut.col_idx      # folded in place
    assert ds.out_deg[0] > 1
    ds.apply_delta(touched)
    assert np.array_equal(ds.out_deg, out_deg(g)) and ds.out_deg[0] == 1


def test_a_vertex_cut_partitioner_raises(graph):
    with pytest.raises(ValueError, match="edge-cut"):
        DistributedMinibatchSampler(graph, 2, R.MB_FANOUTS, R.MB_B,
                                    partitioner="hdrf")
    with pytest.raises(ValueError, match="edge-cut"):
        DistributedMinibatchSampler(graph, 2, R.MB_FANOUTS, R.MB_B,
                                    part=part_mod.grid_vertex_cut(graph, 4))


def test_collate_shapes_stay_static(graph):
    ds = R.minibatch_sampler(graph, 2, "hash")
    caps = ds.block_shapes()
    shapes = set()
    for seeds in R.minibatch_seeds(graph.num_nodes) + [np.arange(3)]:
        a = collate(ds.sample_global(seeds), ds.out_deg)
        shapes.add(tuple((k, l, x.shape) for k, v in a.items()
                         for l, x in enumerate(v if isinstance(v, tuple)
                                               else (v,))))
        for l, (dcap, scap, ecap) in enumerate(caps):
            assert a["es"][l].shape == (2, ecap)
            assert a["sdeg"][l].shape == (2, scap)
        blocks = device_blocks(ds.sample_partition(0, seeds[:1]),
                               ds.out_deg, "cpu")
        assert [(b.num_dst, b.num_src) for b in blocks] == [
            (d, s) for d, s, _ in caps]
    assert len(shapes) == 1


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_a_rank_store_gives_the_full_sampler_batches(graph, rank):
    full = R.minibatch_sampler(graph, 3, "ldg")
    own = R.minibatch_sampler(graph, 3, "ldg", parts=(rank,))
    assert list(own.stores) == [rank]
    for seeds in R.minibatch_seeds(graph.num_nodes):
        a = full.sample_global(seeds)[rank]
        b = own.sample_partition(rank, own.owned_seeds(rank, seeds))
        assert np.array_equal(a.x_in, b.x_in)
        assert np.array_equal(a.seeds, b.seeds)
    c = own.counters()
    s = full.stores[rank]
    assert c == {"hits": s.hits, "misses": s.misses,
                 "cross_partition_bytes": s.transferred_bytes,
                 "local_rows": s.local_rows, "remote_requests": s.requests}
    with pytest.raises(KeyError):
        own.sample_partition((rank + 1) % 3, np.zeros(0, np.int64))


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_the_launcher_trains_on_two_cpu_ranks(worlds, codec):
    """``--devices 2 --minibatch`` through ``main`` (fp32; int8 as a job
    of the world of 2): finite losses, the ranks' parameters bitwise
    equal, and the ranks' traffic over the trained batches summed equals
    one process fed the same seeds."""
    argv = launcher_argv(codec)
    res = (train_gnn.main(argv) if codec == "fp32"
           else worlds["launcher_int8"])
    assert res["mode"] == "minibatch_dist" and res["trained"] == 10
    assert len(res["losses"]) == 10 and np.isfinite(res["losses"]).all()
    first = res["ranks"][0]["params"]
    for r in res["ranks"]:
        assert r["losses"] == res["losses"]
        assert all(np.array_equal(r["params"][i][k], first[i][k])
                   for i in range(2) for k in first[i])
        assert r["sampled"] >= r["trained"]
    args = train_gnn.parse_args(argv)
    g = train_gnn.load_graph(args)
    one = DistributedMinibatchSampler(
        g, 2, [5, 5], args.batch, cache_policy="degree",
        cache_capacity=g.num_nodes // 10, wire_codec=codec)
    rng = np.random.default_rng(args.seed)
    for _ in range(res["trained"]):
        one.sample_global(rng.choice(g.num_nodes, args.batch,
                                     replace=False))
    summed = {k: sum(r["counters"][k] for r in res["ranks"])
              for k in COUNTERS}
    assert summed == one.counters() == res["traffic"]
    assert res["stats"] == one.stats()
    assert summed["cross_partition_bytes"] > 0
