"""The reference's side of the port's distributed tests: the JAX package's
``shard_map`` steps on forced host devices, written to an ``.npz``.

    python tests/torch_dist_reference.py {propagation|async} OUT.npz

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
"""
import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

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


def main():
    what, path = sys.argv[1], sys.argv[2]
    assert jax.device_count() == 4, jax.device_count()
    params0 = GM.init_gnn(GNNConfig(**CFG), jax.random.PRNGKey(0))
    out = {}
    put_params(out, "init", params0)
    {"propagation": propagation, "async": async_runs}[what](out, params0)
    np.savez(path, **out)
    print(f"wrote {len(out)} arrays to {path}")


if __name__ == "__main__":
    main()
