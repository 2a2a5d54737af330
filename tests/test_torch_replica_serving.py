"""The port's replicated serving tier (``repro_torch.serving.{replica,
router}``): the reference's invariants (``tests/test_replica_serving.py``
at the same sizes: a 200-node SBM, buckets (1, 4, 8), fanouts (3, 3)) —
zero drops, zero version-torn batches under a rolling hot-swap, the
autoscaler, dispatch policies, crash-safe stop/resume — then the port
against the reference on the same inputs, weights carried by
``params_from_numpy``: the same autoscaler decisions, and per-request
logits within 1e-5 of the largest reference logit, before and after a
hot swap.

The router's virtual clock advances by each batch's measured compute,
so batching depends on wall time.  The cross-package cases replace the
clock both replica modules read with one that advances a fixed step per
reading: both routers then form the same batches, dispatch the same
requests to the same replicas and swap at the same completions.
"""
import signal

import jax
import numpy as np
import pytest
import torch

from repro.graph import generators as RG
from repro.models.gnn import model as RGM
from repro.serving import AutoscalePolicy as RefPolicy
from repro.serving import AutoScaler as RefScaler
from repro.serving import ReplicaRouter as RefRouter
from repro.serving import replica as ref_replica
from repro_torch.graph import generators as G
from repro_torch.models.gnn import model as GM
from repro_torch.models.gnn.model import GNNConfig
from repro_torch.serving import (AutoscalePolicy, AutoScaler,
                                 InferenceRequest, ReplicaRouter,
                                 RouterStats, ServeStats, poisson_workload,
                                 restore_params)
from repro_torch.serving import replica as port_replica

BUCKETS = (1, 4, 8)
FANOUTS = (3, 3)
NODES = 200


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph_of(gen):
    g = gen.sbm(NODES, 4, p_in=0.9, p_out=0.02, seed=0)
    return gen.featurize(g, 16, seed=0, class_sep=1.5)


@pytest.fixture(scope="module")
def graph():
    return _graph_of(G)


@pytest.fixture(scope="module")
def model(graph):
    cfg = GNNConfig(arch="sage", feat_dim=16, hidden=32,
                    num_classes=graph.num_classes)
    return cfg, _init(cfg, 0)


def _init(cfg, seed):
    return GM.init_gnn(cfg, torch.Generator().manual_seed(seed),
                       device="cpu")


def _router(graph, model, **kw):
    cfg, params = model
    kw.setdefault("n_replicas", 2)
    kw.setdefault("fanouts", FANOUTS)
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("cache_policy", "degree")
    kw.setdefault("cache_capacity", graph.num_nodes)
    kw.setdefault("seed", 0)
    return ReplicaRouter(graph, cfg, params, **kw)


def _workload(graph, n, rate=4000.0, seed=1):
    return poisson_workload(n, np.arange(graph.num_nodes), rate, seed=seed)


# ---------------------------------------------------------------------------
# basics: completion, zero drops, per-replica accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["round_robin", "least_queue"])
def test_all_requests_served_no_drops(graph, model, policy):
    router = _router(graph, model, policy=policy)
    wl = _workload(graph, 48)
    stats = router.run(wl)
    assert stats.served == 48
    assert stats.dropped == 0
    assert sum(r.served for r in router.replicas) == 48
    for r in wl:
        assert r.logits is not None
        assert r.params_version == 0
        assert r.done_s >= r.arrival_s
    # one forward callable across the fleet, one forward shape a bucket
    fwd = router.replicas[0].server._forward
    assert all(r.server._forward is fwd for r in router.replicas)
    assert all(len(r.server.stats.jit_shapes) <= len(BUCKETS)
               for r in router.replicas)
    # every forward counted: the warmups (a bucket each) and a batch each
    assert router.forward_calls == (2 * len(BUCKETS)
                                    + sum(r.batches for r in router.replicas))


def test_round_robin_spreads_traffic(graph, model):
    router = _router(graph, model, policy="round_robin", n_replicas=2)
    router.run(_workload(graph, 40))
    served = sorted(r.served for r in router.replicas)
    assert served[0] >= 10, served


def test_bad_config_rejected(graph, model):
    with pytest.raises(ValueError, match="policy"):
        _router(graph, model, policy="fastest")
    with pytest.raises(ValueError, match="replica"):
        _router(graph, model, n_replicas=0)


# ---------------------------------------------------------------------------
# rolling hot-swap: zero torn batches, one version per response
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared_cache", [True, False])
def test_rolling_hot_swap_zero_torn(graph, model, shared_cache):
    cfg, _ = model
    router = _router(graph, model, shared_cache=shared_cache)
    wl = _workload(graph, 96)
    stats = router.run(wl, hot_swap_every=30,
                       new_params_fn=lambda v: _init(cfg, 100 + v))
    assert stats.served == 96 and stats.dropped == 0
    assert stats.torn_batches == 0
    assert stats.hot_swaps >= 1
    assert router.version == stats.hot_swaps
    versions = {r.params_version for r in wl}
    assert versions <= set(range(router.version + 1))
    assert len(versions) >= 2, "swap must happen mid-stream"
    assert sum(stats.version_counts.values()) == 96
    for r in wl:
        assert stats.version_counts[r.params_version] > 0


def test_hot_swap_staged_then_applied_between_runs(graph, model):
    cfg, _ = model
    router = _router(graph, model)
    new = _init(cfg, 42)
    assert router.hot_swap(new) == 1
    with pytest.raises(RuntimeError, match="in flight"):
        router.hot_swap(new)
    stats = router.run(_workload(graph, 16))
    assert router.version == 1
    assert all(r.version == 1 for r in router.replicas)
    assert all(r.server.params is new for r in router.replicas)
    assert stats.torn_batches == 0


def test_hot_swap_version_must_grow(graph, model):
    cfg, _ = model
    router = _router(graph, model)
    with pytest.raises(ValueError, match="grow"):
        router.hot_swap(_init(cfg, 1), version=0)


def test_shared_cache_flips_with_first_replica(graph, model):
    """After a rollout the shared cache serves the new version only; and
    while a rollout is half done, the replica still on the old weights
    neither reads nor fills the flipped cache."""
    cfg, _ = model
    router = _router(graph, model, shared_cache=True)
    router.run(_workload(graph, 64), hot_swap_every=32,
               new_params_fn=lambda v: _init(cfg, v))
    assert router.shared_cache.params_version == router.version
    assert all(r.version == router.version for r in router.replicas)

    v = router.hot_swap(_init(cfg, 77))
    router._progress_rollout(vnow=1e9)          # one replica per pass
    new, old = sorted(router.replicas, key=lambda r: -r.version)
    assert (new.version, old.version) == (v, v - 1)
    assert router.shared_cache.params_version == v
    hits, misses = router.shared_cache.hits, router.shared_cache.misses
    old.server.warmup(reset_cache_stats=False)
    assert (router.shared_cache.hits, router.shared_cache.misses) == (
        hits, misses), "an old-version replica touched the flipped cache"


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------

def test_autoscaler_scales_up_on_queue_depth():
    sc = AutoScaler(AutoscalePolicy(max_replicas=4,
                                    target_queue_per_replica=4.0))
    assert sc.decide(1.0, [10, 10], 2) == 1
    assert sc.decide(1.01, [10, 10], 3) == 0        # cooldown
    assert sc.decide(2.0, [10, 10, 10], 3) == 1
    assert sc.events[0]["action"] == "up"


def test_autoscaler_respects_max_and_scales_down():
    p = AutoscalePolicy(min_replicas=1, max_replicas=2,
                        target_queue_per_replica=4.0,
                        low_queue_per_replica=1.0, scale_down_after=2,
                        cooldown_s=0.0)
    sc = AutoScaler(p)
    assert sc.decide(1.0, [100, 100], 2) == 0       # at max: no scale-up
    assert sc.decide(2.0, [0, 0], 2) == 0           # low check 1
    assert sc.decide(3.0, [0, 0], 2) == -1          # low check 2 -> down
    assert sc.decide(4.0, [0], 1) == 0              # at min: stays
    assert [e["action"] for e in sc.events] == ["down"]


def test_autoscaler_p99_slo_trigger():
    sc = AutoScaler(AutoscalePolicy(slo_p99_s=0.010,
                                    target_queue_per_replica=1e9))
    for _ in range(32):
        sc.observe_latency(0.050)
    assert sc.recent_p99() > 0.010
    assert sc.decide(1.0, [0], 1) == 1


def test_router_scales_up_under_burst(graph, model):
    router = _router(graph, model, n_replicas=1,
                     autoscale=AutoscalePolicy(
                         min_replicas=1, max_replicas=4,
                         target_queue_per_replica=4.0,
                         check_every_s=0.002, cooldown_s=0.004))
    stats = router.run(_workload(graph, 96, rate=12000.0))
    assert stats.served == 96 and stats.dropped == 0
    assert stats.replicas_peak >= 2, stats.summary()
    assert any(e["action"] == "up" for e in stats.scale_events)
    up = next(e for e in stats.scale_events if e["action"] == "up")
    assert up["queue_per_replica"] > 4.0
    # a replica added mid-run shares the first replica's forward
    fwd = router.replicas[0].server._forward
    assert all(r.server._forward is fwd for r in router.replicas)


def test_hot_swap_completes_while_replica_draining(graph, model):
    cfg, _ = model
    router = _router(graph, model, n_replicas=3)
    router.replicas[2].draining = True
    assert router.hot_swap(_init(cfg, 7)) == 1
    stats = router.run(_workload(graph, 48))
    assert router._rollout is None, "rollout wedged on a draining replica"
    assert router.version == 1
    assert stats.served == 48 and stats.dropped == 0
    assert stats.torn_batches == 0
    assert len(router.replicas) == 2
    assert all(r.version == 1 for r in router.replicas)


def test_least_queue_tie_break_is_deterministic(graph, model):
    router = _router(graph, model, n_replicas=3, policy="least_queue")
    for r in router.replicas:
        r.busy_until = 0.0
    want = [(1, 0, 0), (1, 1, 0), (1, 1, 1),
            (2, 1, 1), (2, 2, 1), (2, 2, 2)]
    for req, expect in zip(_workload(graph, 6), want):
        router._dispatch(req)
        assert tuple(r.queue_depth() for r in router.replicas) == expect


def test_router_never_livelocks_on_deadline_rounding(graph, model):
    """The clock jump lands exactly on fl(oldest + max_wait); the loop
    must still make progress (see request.advance_vclock)."""
    router = _router(graph, model, n_replicas=1)
    wl = [InferenceRequest(0, 3, 0.017512410335686807),
          InferenceRequest(1, 4, 5.0)]

    def _hang(signum, frame):
        raise TimeoutError("router loop livelocked on the max_wait deadline")

    old = signal.signal(signal.SIGALRM, _hang)
    signal.alarm(60)
    try:
        stats = router.run(wl)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    assert stats.served == 2 and stats.dropped == 0


def test_router_drains_on_scale_down(graph, model):
    router = _router(graph, model, n_replicas=3)
    router.replicas[2].draining = True
    stats = router.run(_workload(graph, 48))
    assert stats.served == 48 and stats.dropped == 0
    assert len(router.replicas) == 2
    # the reaped replica's warmup forwards still count
    assert router.forward_calls == 3 * len(BUCKETS) + stats.batches


# ---------------------------------------------------------------------------
# stop/resume through the checkpoint plane
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(graph, model, tmp_path):
    cfg, params = model
    router = _router(graph, model)
    router.run(_workload(graph, 32), hot_swap_every=16,
               new_params_fn=lambda v: _init(cfg, v))
    assert router.version >= 1
    router.save(str(tmp_path))
    restored, version = restore_params(str(tmp_path), params)
    assert version == router.version
    for (k, a), (k2, b) in zip(restored.state_dict().items(),
                               router.params.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k


def test_resume_serves_restored_version(graph, model, tmp_path):
    cfg, params = model
    saver = _router(graph, model, n_replicas=1)
    saver.run(_workload(graph, 24), hot_swap_every=12,
              new_params_fn=lambda v: _init(cfg, v))
    saver.save(str(tmp_path))
    restored, version = restore_params(str(tmp_path), params)

    fresh = _router(graph, model, n_replicas=2)
    fresh.hot_swap(restored, version=version)
    wl = _workload(graph, 24, seed=5)
    stats = fresh.run(wl)
    assert fresh.version == version
    assert stats.torn_batches == 0
    assert wl[-1].params_version == version


# ---------------------------------------------------------------------------
# stats hardening: no NaNs out of empty/zero-elapsed stats
# ---------------------------------------------------------------------------

def test_serve_stats_empty_and_zero_elapsed():
    s = ServeStats()
    assert s.throughput_rps == 0.0
    assert s.latency_quantile(0.5) == 0.0
    out = s.summary()
    assert out["p50_ms"] == 0.0 and out["p99_ms"] == 0.0
    assert out["throughput_rps"] == 0.0
    s.served = 10
    s.wall_s = 0.0
    assert s.throughput_rps == 0.0
    s.wall_s = float("inf")
    assert s.throughput_rps == 0.0


def test_router_stats_empty():
    s = RouterStats()
    assert s.throughput_rps == 0.0
    assert s.latency_quantile(0.99) == 0.0
    out = s.summary()
    assert out["served"] == 0 and out["p99_ms"] == 0.0


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def test_autoscaler_decisions_match_reference():
    """One sequence of latency observations and control steps through
    both autoscalers: the same return values and the same events."""
    kw = dict(min_replicas=1, max_replicas=3, target_queue_per_replica=4.0,
              low_queue_per_replica=1.0, slo_p99_s=0.02, cooldown_s=0.01,
              scale_down_after=2, p99_window=8)
    ref, port = RefScaler(RefPolicy(**kw)), AutoScaler(AutoscalePolicy(**kw))
    rng = np.random.default_rng(3)
    n = 1
    for step in range(200):
        # a burst, then quiet: both directions of scaling
        busy = step < 100
        for lat in rng.exponential(0.01 if busy else 0.001,
                                   rng.integers(0, 4)):
            ref.observe_latency(float(lat))
            port.observe_latency(float(lat))
        depths = [int(d) for d in rng.integers(0, 12 if busy else 2, n)]
        vnow = 0.004 * step
        want = ref.decide(vnow, depths, n)
        assert port.decide(vnow, depths, n) == want, step
        assert port.recent_p99() == ref.recent_p99()
        n += want
    assert port.events == ref.events
    assert {e["action"] for e in port.events} == {"up", "down"}


class _Tick:
    """Stands in for a replica module's ``time``: every ``perf_counter``
    reading advances a fixed step, so each batch's measured compute (two
    readings apart) is the same in both packages."""

    def __init__(self, step=2.5e-4):
        self.t, self.step = 0.0, step

    def perf_counter(self):
        self.t += self.step
        return self.t


def _ref_tree(cfg, seed):
    return jax.tree.map(np.asarray, RGM.init_gnn(cfg, jax.random.PRNGKey(
        seed)))


def _twin_routers(monkeypatch, **kw):
    """The reference's router and the port's, on the same graph and
    weights, with the fixed-step clock."""
    monkeypatch.setattr(ref_replica, "time", _Tick())
    monkeypatch.setattr(port_replica, "time", _Tick())
    ref_g, g = _graph_of(RG), _graph_of(G)
    ckw = dict(arch="sage", feat_dim=16, hidden=32,
               num_classes=g.num_classes)
    ref_cfg, cfg = RGM.GNNConfig(**ckw), GNNConfig(**ckw)
    tree = _ref_tree(ref_cfg, 0)
    rkw = dict(n_replicas=2, fanouts=FANOUTS, buckets=BUCKETS,
               cache_policy="degree", cache_capacity=NODES,
               max_staleness=0, seed=0, **kw)
    ref = RefRouter(ref_g, ref_cfg, tree, **rkw)
    port = ReplicaRouter(g, cfg, GM.params_from_numpy(cfg, tree,
                                                      device="cpu"), **rkw)
    return ref, port, ref_cfg, cfg


def _assert_same_responses(ref_wl, wl):
    for a, b in zip(ref_wl, wl):
        assert (b.req_id, b.node_id) == (a.req_id, a.node_id)
        assert b.params_version == a.params_version, b.req_id
        want = np.asarray(a.logits)
        np.testing.assert_allclose(b.logits, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("policy", ["round_robin", "least_queue"])
def test_router_answers_match_reference(monkeypatch, policy):
    """2 replicas, one shared cache at staleness 0: every response within
    1e-5 of the largest logit of the reference's response to the same
    request, and the same per-replica dispatch, batches and hit counts."""
    ref, port, _, _ = _twin_routers(monkeypatch, policy=policy)
    ref_wl, wl = _workload(ref.g, 64), _workload(port.g, 64)
    ref_stats, stats = ref.run(ref_wl), port.run(wl)
    _assert_same_responses(ref_wl, wl)
    assert ([r.summary() for r in port.replicas]
            == [r.summary() for r in ref.replicas])
    assert stats.batches == ref_stats.batches
    assert port.shared_cache.hits == ref.shared_cache.hits > 0


def test_router_hot_swap_answers_match_reference(monkeypatch):
    """A rolling hot swap every 20 completions, both packages given the
    same weights per version: each response carries the reference's
    version and matches the reference's response under it."""
    ref, port, ref_cfg, cfg = _twin_routers(monkeypatch,
                                            policy="round_robin")
    trees = {v: _ref_tree(ref_cfg, 100 + v) for v in range(1, 8)}
    ref_wl, wl = _workload(ref.g, 96), _workload(port.g, 96)
    ref_stats = ref.run(ref_wl, hot_swap_every=20,
                        new_params_fn=lambda v: trees[v])
    stats = port.run(wl, hot_swap_every=20,
                     new_params_fn=lambda v: GM.params_from_numpy(
                         cfg, trees[v], device="cpu"))
    _assert_same_responses(ref_wl, wl)
    assert stats.hot_swaps == ref_stats.hot_swaps >= 2
    assert stats.version_counts == ref_stats.version_counts
    assert stats.torn_batches == 0
    assert len({r.params_version for r in wl}) >= 3
