"""The reference's side of the port's distributed tests: the JAX package's
``shard_map`` steps on forced host devices, written to an ``.npz``.

    python tests/torch_dist_reference.py {propagation|async|minibatch|p3} OUT.npz

Runs in a subprocess of its own (``--xla_force_host_platform_device_count
=4`` must be set before JAX starts); a world of 2 uses the first two
devices.  The graph and sizes are the reference's check sizes
(``tests/async_train_check.py``): ``sbm(144, 4)``, 16 → 32 → 4, AdamW at
1e-2 without decay, from ``init_gnn(cfg, PRNGKey(0))`` (saved beside, so
the port starts from the same numbers).

* ``propagation``: 10 steps of each synchronous mode (pull, push, stale
  with the input features as its halo), under AdamW and under SGD, at 2
  and 4 devices.
* ``async``: 10 epochs of ``AsyncFullGraphTrainer`` at S 0 and 2
  (``refresh_frac`` 0.05) at 2 and 4 devices, with their bytes per step;
  and at 2 devices a run with a synthesized stream of 40 events folded
  20 at a time between three 1-epoch runs, with each fold's summary.
* ``minibatch``: the distributed mini-batch pipeline at the sizes of
  ``tests/distributed_train_check.py`` (B 24, fanouts [3, 3], degree
  cache of a tenth of the nodes, 3 AdamW steps on seeds drawn from
  ``default_rng(1)``): worlds 2 and 4 × hash and ldg × GCN and SAGE, and
  GIN and GAT at world 2 with hash.  Each step's ``collate`` arrays and
  each partition's seeds and block sources are saved (once a world and
  partitioner), with ``stats()``, the losses and the final parameters;
  GIN and GAT also under 3 SGD steps.
* ``p3``: ``make_p3_train_step`` at 2 and 4 devices, 10 AdamW and 10 SGD
  steps (the SGD optimizer carries AdamW's state layout, which the
  step's ``shard_map`` specs name), with the losses and the parameters
  (device 0's copy of the replicated ones); and 10 AdamW steps of the
  single-device full-graph GCN on the same graph, the function P3
  computes (the reference's P3 clips AdamW's gradients by each device's
  own W1 slice, so under AdamW it drifts from it).
"""
import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import parallel as PL  # noqa: E402
from repro.core import propagation as PR  # noqa: E402
from repro.core.updates import synthesize_updates  # noqa: E402
from repro.graph import generators as G  # noqa: E402
from repro.models.gnn import model as GM  # noqa: E402
from repro.models.gnn.model import GNNConfig  # noqa: E402
from repro.optim import AdamW, Sgd  # noqa: E402

STEPS = 10
WORLDS = (2, 4)
MODES = ("pull", "push", "stale")
STALENESS = (0, 2)
REFRESH_FRAC = 0.05
STREAM_EVENTS, FOLD = 40, 20


def graph():
    g = G.sbm(144, 4, p_in=0.9, p_out=0.02, seed=0)
    return G.featurize(g, 16, seed=0, class_sep=1.5)


CFG = dict(arch="gcn", feat_dim=16, hidden=32, num_classes=4)
OPTS = {"adamw": lambda: AdamW(lr=1e-2, weight_decay=0.0),
        "sgd": lambda: Sgd(lr=0.1)}


def put_params(out, prefix, params):
    for i, p in enumerate(params):
        for k, v in p.items():
            out[f"{prefix}/{i}/{k}"] = np.asarray(v)


def propagation(out, params0):
    g = graph()
    for n_dev in WORLDS:
        sg = PR.shard_graph(g, n_dev, method="hash")
        push_arrays = PR.push_layout(sg, g)
        for mode in MODES:
            for oname, make in OPTS.items():
                opt = make()
                _, step = PR.make_distributed_gcn_step(opt, n_dev, mode=mode)
                params, ostate = params0, opt.init(params0)
                losses = []
                for _ in range(STEPS):
                    if mode == "push":
                        params, ostate, loss = step(
                            params, ostate, sg, push_arrays=push_arrays)
                    else:
                        params, ostate, loss = step(params, ostate, sg,
                                                    halo_cache=sg.x)
                    losses.append(float(loss))
                key = f"{mode}/{oname}/{n_dev}"
                put_params(out, key, params)
                out[f"{key}/losses"] = np.array(losses)


def async_runs(out, params0):
    from repro.distributed import AsyncFullGraphTrainer
    cfg = GNNConfig(**CFG)
    for n_dev in WORLDS:
        for s in STALENESS:
            opt = OPTS["adamw"]()
            tr = AsyncFullGraphTrainer(graph(), cfg, opt, n_dev,
                                       partitioner="hash", staleness=s,
                                       refresh_frac=REFRESH_FRAC)
            params, _, _ = tr.run(params0, opt.init(params0), STEPS)
            key = f"async/{s}/{n_dev}"
            put_params(out, key, params)
            out[f"{key}/bytes_per_step"] = np.array(
                tr.stats()["bytes_per_step"])
    # an update stream folded between epochs
    g = graph()
    log = synthesize_updates(g, STREAM_EVENTS, seed=1)
    opt = OPTS["adamw"]()
    tr = AsyncFullGraphTrainer(dataclasses.replace(g), cfg, opt, 2,
                               partitioner="hash", staleness=2,
                               refresh_frac=REFRESH_FRAC)
    params, ostate = params0, opt.init(params0)
    folds = []
    for _ in range(3):
        params, ostate, _ = tr.run(params, ostate, 1)
        if tr._update_seq < log.last_seq:
            f = tr.fold_updates(log, tr._update_seq + FOLD)
            folds.append([f["events"], f["touched_nodes"],
                          f["invalidated_rows"], f["upto_seq"]])
    out["fold/summaries"] = np.array(folds)
    out["fold/versions"] = np.stack([b.version for b in tr.exchange.buffers])
    put_params(out, "fold", params)


MB_B, MB_FANOUTS, MB_STEPS = 24, [3, 3], 3
MB_RUNS = [(w, m, a) for w in WORLDS for m in ("hash", "ldg")
           for a in ("gcn", "sage")] + [(2, "hash", "gin"),
                                        (2, "hash", "gat")]
P3_STEPS = 10


def minibatch_seeds(n_nodes: int):
    rng = np.random.default_rng(1)
    return [rng.choice(n_nodes, MB_B, replace=False)
            for _ in range(MB_STEPS)]


def minibatch(out, params0):
    import jax.numpy as jnp

    from repro.distributed import (DistributedMinibatchSampler, collate,
                                   make_distributed_minibatch_step)
    g = graph()
    seeds = minibatch_seeds(g.num_nodes)
    steps = {}          # one jitted step a (world, arch, optimizer)
    for n_dev, method, arch in MB_RUNS:
        cfg = GNNConfig(**dict(CFG, arch=arch))
        p0 = GM.init_gnn(cfg, jax.random.PRNGKey(0))
        put_params(out, f"mb/init/{arch}", p0)
        opts = ["adamw"] + (["sgd"] if arch in ("gin", "gat") else [])
        for oname in opts:
            ds = DistributedMinibatchSampler(
                g, n_dev, MB_FANOUTS, MB_B, partitioner=method,
                cache_policy="degree", cache_capacity=g.num_nodes // 10,
                seed=0)
            if (n_dev, arch, oname) not in steps:
                opt = OPTS[oname]()
                steps[n_dev, arch, oname] = opt, \
                    make_distributed_minibatch_step(cfg, opt, n_dev,
                                                    ds.block_shapes())[1]
            opt, step = steps[n_dev, arch, oname]
            params, ostate = p0, opt.init(p0)
            losses = []
            wkey = f"mb/{n_dev}/{method}"
            for t, s in enumerate(seeds):
                batches = ds.sample_global(s)
                arrays = collate(batches, ds.out_deg)
                params, ostate, loss = step(params, ostate, jax.tree.map(
                    jnp.asarray, arrays))
                losses.append(float(loss))
                if arch == "gcn" and oname == "adamw":
                    for k, v in arrays.items():
                        for l, a in enumerate(v if isinstance(v, tuple)
                                              else (v,)):
                            out[f"{wkey}/{t}/{k}/{l}"] = np.asarray(a)
                    for b in batches:
                        out[f"{wkey}/{t}/seeds/{b.part}"] = b.seeds
                        for l, blk in enumerate(b.blocks):
                            out[f"{wkey}/{t}/src/{b.part}/{l}"] = \
                                blk.src_nodes
            if arch == "gcn" and oname == "adamw":
                st = ds.stats()
                for k in ("halo_hit_ratio", "cross_partition_bytes",
                          "local_rows", "remote_requests",
                          "ghost_fraction"):
                    out[f"{wkey}/stats/{k}"] = np.array(st[k])
            key = f"mb/{n_dev}/{method}/{arch}/{oname}"
            put_params(out, key, params)
            out[f"{key}/losses"] = np.array(losses)


class _SgdAdamLayout:
    """SGD (lr 0.1) whose state mirrors AdamW's ``{m, v, step}``: the P3
    step's ``shard_map`` specs name that layout for any optimizer."""

    def __init__(self, lr):
        self.sgd = Sgd(lr=lr)
        self.adam = AdamW(lr=lr, weight_decay=0.0)

    def init(self, params):
        return self.adam.init(params)

    def apply(self, params, grads, state):
        params, s = self.sgd.apply(params, grads, {"step": state["step"]})
        return params, dict(state, step=s["step"])


def p3(out, params0):
    import jax.numpy as jnp
    g = graph()
    for n_dev in WORLDS:
        sg = PR.shard_graph(g, n_dev, method="hash")
        e = g.edges()
        es = sg.perm[e[:, 0]].astype(np.int32)
        ed = sg.perm[e[:, 1]].astype(np.int32)
        coef = (1 / np.sqrt(sg.out_deg[es]) / np.sqrt(sg.in_deg[ed])
                ).astype(np.float32)
        inputs = [jnp.asarray(a) for a in (
            sg.x, es, ed, np.ones(len(e), np.float32), coef, sg.labels,
            sg.label_mask)]
        for oname in OPTS:
            opt = (AdamW(lr=1e-2, weight_decay=0.0) if oname == "adamw"
                   else _SgdAdamLayout(0.1))
            _, step = PL.make_p3_train_step(opt, n_dev)
            step = jax.jit(step)
            params = [dict(p) for p in params0]
            ostate = opt.init(params)
            losses = []
            for _ in range(P3_STEPS):
                params, ostate, loss = step(params, ostate, *inputs)
                losses.append(float(loss))
            key = f"p3/{oname}/{n_dev}"
            put_params(out, key, params)
            out[f"{key}/losses"] = np.array(losses)
    from repro.core.abstraction import DeviceGraph
    opt = AdamW(lr=1e-2, weight_decay=0.0)
    step = jax.jit(GM.make_fullgraph_train_step(GNNConfig(**CFG), opt))
    dg = DeviceGraph.from_graph(g)
    params, ostate = params0, opt.init(params0)
    losses = []
    for _ in range(P3_STEPS):
        params, ostate, loss = step(params, ostate, dg, jnp.asarray(
            g.features), jnp.asarray(g.labels), jnp.ones(g.num_nodes))
        losses.append(float(loss))
    put_params(out, "p3/adamw/single", params)
    out["p3/adamw/single/losses"] = np.array(losses)


def main():
    what, path = sys.argv[1], sys.argv[2]
    assert jax.device_count() == 4, jax.device_count()
    params0 = GM.init_gnn(GNNConfig(**CFG), jax.random.PRNGKey(0))
    out = {}
    put_params(out, "init", params0)
    {"propagation": propagation, "async": async_runs,
     "minibatch": minibatch, "p3": p3}[what](out, params0)
    np.savez(path, **out)
    print(f"wrote {len(out)} arrays to {path}")


if __name__ == "__main__":
    main()
