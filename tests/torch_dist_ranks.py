"""The port's side of the distributed tests: rank functions that
``repro_torch.launch.train_gnn.run_world`` runs in every spawned rank (as
``functools.partial`` jobs), on the graph and sizes of
``tests/torch_dist_reference.py``.  Imports torch and the port only, so a
rank starts without JAX.  Each returns the rank's losses and final
parameters as numpy (P3's W1 as the rank's slice)."""
import dataclasses

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.core import coordination
from repro_torch.core import parallel as PL
from repro_torch.core import propagation as PR
from repro_torch.core.updates import synthesize_updates
from repro_torch.distributed import (DistributedMinibatchSampler,
                                     make_distributed_minibatch_step)
from repro_torch.graph import generators as G
from repro_torch.models.gnn import model as GM
from repro_torch.optim import AdamW, Sgd

STEPS = 10
CFG = dict(arch="gcn", feat_dim=16, hidden=32, num_classes=4)
OPTS = {"adamw": lambda ps: AdamW(ps, lr=1e-2, weight_decay=0.0),
        "sgd": lambda ps: Sgd(ps, lr=0.1)}


def graph():
    g = G.sbm(144, 4, p_in=0.9, p_out=0.02, seed=0)
    return G.featurize(g, 16, seed=0, class_sep=1.5)


def params_np(model) -> list:
    return [{k: v.detach().cpu().numpy() for k, v in layer.named_parameters()}
            for layer in model]


def _model(params0, dev, **kw):
    cfg = GM.GNNConfig(**dict(CFG, **kw))
    return cfg, GM.params_from_numpy(cfg, params0, device=dev)


def sync_run(rank, world, dev, *, mode, params0, opt="adamw"):
    """``STEPS`` steps of a synchronous mode (``propagation.run_sync``,
    the launcher's driver; stale reads the input features as its
    halo)."""
    g = graph()
    sg = PR.shard_graph(g, world, method="hash")
    _, model = _model(params0, dev)
    out = PR.run_sync(model, OPTS[opt](model.parameters()), sg, g, rank,
                      dev, mode=mode, steps=STEPS)
    return {"losses": out["losses"], "params": params_np(model)}


def async_run(rank, world, dev, *, staleness, params0, refresh_frac=0.05,
              codec="fp32"):
    """``STEPS`` epochs of the asynchronous trainer."""
    from repro_torch.distributed import AsyncFullGraphTrainer
    cfg, model = _model(params0, dev, wire_codec=codec)
    tr = AsyncFullGraphTrainer(graph(), cfg, OPTS["adamw"](
        model.parameters()), world, staleness=staleness,
        refresh_frac=refresh_frac, device=dev)
    tr.run(model, STEPS)
    return {"losses": tr.losses, "params": params_np(model),
            "stats": tr.stats(), "ghost_digest": tr.ghost_digest()}


def fold_run(rank, world, dev, *, params0, events=40, fold=20):
    """Three 1-epoch runs of the asynchronous trainer (S 2) with a
    synthesized stream folded ``fold`` events at a time between them."""
    from repro_torch.distributed import AsyncFullGraphTrainer
    g = graph()
    log = synthesize_updates(g, events, seed=1)
    cfg, model = _model(params0, dev)
    tr = AsyncFullGraphTrainer(dataclasses.replace(g), cfg, OPTS["adamw"](
        model.parameters()), world, staleness=2, refresh_frac=0.05,
        device=dev)
    folds = []
    for _ in range(3):
        tr.run(model, 1)
        if tr._update_seq < log.last_seq:
            f = tr.fold_updates(log, tr._update_seq + fold)
            folds.append([f["events"], f["touched_nodes"],
                          f["invalidated_rows"], f["upto_seq"]])
    return {"folds": folds, "params": params_np(model),
            "versions": np.stack([b.version for b in tr.exchange.buffers])}


def coordination_run(rank, world, dev):
    """Both coordinators on the same per-rank gradients (every rank's its
    own), three AdamW steps each from the same parameters: the largest
    difference of the parameters."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(16, 32), (32,), (32, 4), (4,)]
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) * (1 + q) for s in shapes]
             for q in range(world)][rank]
    out = {}
    for name, fn in coordination.COORDINATORS.items():
        ps = [torch.nn.Parameter(t.clone().to(dev)) for t in init]
        opt = AdamW(ps, lr=1e-2, weight_decay=0.0)
        for _ in range(3):
            fn(opt, ps, [g.to(dev) for g in grads])
        out[name] = [p.detach().cpu().numpy() for p in ps]
    diff = max(float(np.abs(a - b).max()) for a, b in
               zip(out["decentralized"], out["parameter_server"]))
    return {"max_diff": diff, "comm": C.STATS.snapshot(),
            "params": out["decentralized"]}


MB_B, MB_FANOUTS, MB_STEPS = 24, [3, 3], 3


def minibatch_seeds(n_nodes: int) -> list:
    """The global seed batches of the reference's ``minibatch`` mode."""
    rng = np.random.default_rng(1)
    return [rng.choice(n_nodes, MB_B, replace=False)
            for _ in range(MB_STEPS)]


def minibatch_sampler(g, world, method, parts=None):
    return DistributedMinibatchSampler(
        g, world, MB_FANOUTS, MB_B, partitioner=method,
        cache_policy="degree", cache_capacity=g.num_nodes // 10, seed=0,
        parts=parts)


def minibatch_run(rank, world, dev, *, method, arch, params0, opt="adamw"):
    """``MB_STEPS`` steps of the distributed mini-batch step on the rank's
    own partition (its store alone): the losses, the parameters, the
    rank's batches and its store's counters."""
    g = graph()
    cfg, model = _model(params0, dev, arch=arch)
    ds = minibatch_sampler(g, world, method, parts=(rank,))
    step = make_distributed_minibatch_step(cfg, OPTS[opt](
        model.parameters()))
    losses, batches = [], []
    for seeds in minibatch_seeds(g.num_nodes):
        b = ds.sample_partition(rank, ds.owned_seeds(rank, seeds))
        losses.append(float(step(model, b, ds.out_deg, len(seeds))))
        batches.append(b)
    return {"losses": losses, "params": params_np(model),
            "batches": batches, "counters": ds.counters()}


def p3_run(rank, world, dev, *, params0, opt="adamw", steps=STEPS):
    """``steps`` P3 steps (hash cut) from the reference's parameters."""
    g = graph()
    cfg = GM.GNNConfig(**CFG)
    model = PL.p3_params(cfg, params0, rank, world, device=dev)
    shard = PL.p3_shard(PR.shard_graph(g, world, method="hash"), g, rank,
                        dev)
    step = PL.make_p3_train_step(OPTS[opt](model.parameters()))
    losses = [float(step(model, shard)) for _ in range(steps)]
    return {"losses": losses, "params": params_np(model)}


def p3_grads(rank, world, dev, *, params0):
    """One P3 forward and backward from the reference's parameters: each
    parameter's gradient before and after ``sum_grads_and_loss`` with W1
    kept, as the P3 step sums them."""
    g = graph()
    model = PL.p3_params(GM.GNNConfig(**CFG), params0, rank, world,
                         device=dev)
    shard = PL.p3_shard(PR.shard_graph(g, world, method="hash"), g, rank,
                        dev)
    loss = PR.local_loss(PL.p3_forward(model, shard), shard, shard.count)
    loss.backward()

    def grads():
        return [{k: v.grad.detach().cpu().numpy().copy()
                 for k, v in layer.named_parameters()} for layer in model]

    before = grads()
    PR.sum_grads_and_loss(model, loss, keep=(model[0].w,))
    return {"before": before, "after": grads()}


def moe_ep_run(rank, world, dev, *, cfg, params, x, capacity_factor):
    """One MoE block under expert parallelism: ``params`` the layer's full
    parameters as numpy (each rank keeps its experts' rows,
    ``parallel.expert_shard``), ``x`` (B, S, D) the same on every rank.
    Returns the rank's output and how many experts it held."""
    p = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in params.items()}
    p = PL.expert_shard(cfg, p, rank, world)
    y = PL.moe_expert_parallel(cfg, p, torch.from_numpy(x).to(dev),
                               capacity_factor=capacity_factor)
    return {"y": y.cpu().numpy(), "experts": int(p["w_in"].shape[0])}


def moe_ep_forward(rank, world, dev, *, cfg, tree, tokens):
    """A whole ``moe`` model's forward with ``moe_impl="ep"`` in the
    world: every rank holds all parameters and takes its experts' rows.
    Returns the logits."""
    from repro_torch.models.transformer import model as TM
    params = TM.params_from_numpy(cfg, tree, device=dev)
    logits = TM.forward(cfg, params, {"tokens": torch.from_numpy(
        tokens).to(dev)})
    return {"logits": logits.cpu().numpy()}


def _lm_batch(cfg, rng, B, S):
    """A train batch of ``cfg``'s family drawn from ``rng``: tokens and
    labels; vlm's embeddings and M-RoPE positions (3, B, S), each stream
    offset from the others; encdec's encoder frame embeddings."""
    batch = {"labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (B, S)))}
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
        pos = np.arange(S)[None, None] + np.arange(3)[:, None, None] * 3
        batch["positions"] = torch.from_numpy(
            np.broadcast_to(pos, (3, B, S)).astype(np.int32).copy())
        return batch
    batch["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (B, S)))
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    return batch


def sharded_lm_step(rank, world, dev, *, arch, overrides=None,
                    plain_overrides=None, seed=0):
    """One AdamW train step (remat on), a prefill and a decode step of a
    reduced float32 config in this world, twice: on plain tensors, and on
    DTensors over a 2x2 ("data", "model") mesh with the params placed by
    the sharding rules' ``param_specs`` (FSDP for the step, not for the
    serving calls), the cache by ``cache_specs``, and the rules active.
    The decode step runs in a cache drawn from the seed (32 positions, a
    ring of ``sliding_window`` slots when that is smaller), at position 5,
    or 37 in a ring (past its wrap); with a ring, a second decode step at
    position 32 runs in the prefill's own cache (the prompt's last rows
    rolled into their slots).  ``plain_overrides`` change the plain run's
    config only (``moe_impl="ep"`` differentiates only under the rules).
    Returns both runs' loss, grad norm, the prefill's logits and the
    decode steps' logits (the sharded ones gathered; ``None`` for the
    second step without a ring)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.models.transformer import model as TM
    cfg = get_config(arch).reduced().replace(**(overrides or {}))
    plain_cfg = cfg.replace(**(plain_overrides or {}))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    B, S = 4, 32
    rng = np.random.default_rng(seed)
    batch = _lm_batch(cfg, rng, B, S)
    serve = {k: v for k, v in batch.items() if k != "labels"}
    ring = bool(cfg.sliding_window) and cfg.sliding_window < S
    pos = S + 5 if ring else 5
    if cfg.family == "vlm":
        token = {"embeds": torch.from_numpy(rng.standard_normal(
            (B, 1, cfg.d_model)).astype(np.float32))}
    else:
        token = {"token": batch["tokens"][:, :1]}

    def params():
        return TM.init_params(cfg, torch.Generator().manual_seed(seed),
                              device="cpu")

    def step(c, p, b):
        opt = AdamW(TM.trainable(p), lr=1e-3)
        m = TM.make_train_step(c, opt, remat=True)(p, b)
        return m["loss"], m["grad_norm"]

    def cache():
        gen = torch.Generator().manual_seed(seed + 1)
        return shd.map_tree(lambda t: torch.randn(
            t.shape, generator=gen).to(t.dtype), TM.init_cache(
                cfg, B, S, enc_len=S, device="meta"))

    out = {}
    loss, gnorm = step(plain_cfg, params(), batch)
    with torch.no_grad():
        logits, pc = TM.prefill(plain_cfg, params(), serve)
        dec, _ = TM.decode_step(plain_cfg, params(), cache(),
                                {**token, "pos": pos})
        again = TM.decode_step(plain_cfg, params(), pc,
                               {**token, "pos": S})[0].numpy() if ring \
            else None
    out["plain"] = [float(loss), float(gnorm), logits.numpy(), dec.numpy(),
                    again]

    rules = shd.ShardingRules(mesh, batch_size=B)
    b_sh = shd.distribute(batch, shd.batch_specs(batch, mesh, rules), mesh)
    s_sh = {k: v for k, v in b_sh.items() if k != "labels"}
    p0 = params()
    p_sh = shd.distribute(p0, shd.param_specs(p0, mesh, fsdp=True), mesh,
                          requires_grad=True)
    with rules.activate(), implicit_replication():
        loss, gnorm = step(cfg, p_sh, b_sh)
        p_serve = shd.distribute(p0, shd.param_specs(p0, mesh, fsdp=False),
                                 mesh)
        c0 = cache()
        c_sh = shd.distribute(c0, shd.cache_specs(c0, mesh, rules), mesh)
        t_sh = shd.distribute(token, shd.batch_specs(token, mesh, rules),
                              mesh)
        with torch.no_grad():
            logits, pc = TM.prefill(cfg, p_serve, s_sh)
            dec, _ = TM.decode_step(cfg, p_serve, c_sh, {**t_sh, "pos": pos})
            again = TM.decode_step(cfg, p_serve, pc, {**t_sh, "pos": S})[
                0].full_tensor().numpy() if ring else None
    out["sharded"] = [float(loss.full_tensor()), float(gnorm.full_tensor()),
                      logits.full_tensor().numpy(), dec.full_tensor().numpy(),
                      again]
    return out


def host_mesh_forward(rank, world, dev, *, arch, seed=0):
    """A reduced float32 config's forward on the 1x1 host mesh
    (``launch.mesh.make_host_mesh`` on this world's one rank), its params
    placed by ``param_specs`` and the rules active, beside the same
    forward on plain tensors.  Returns the mesh's axes and shape and both
    logits."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import model as TM
    cfg = get_config(arch).reduced()
    mesh = make_host_mesh(dev.type)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 16)))}
    p0 = TM.init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    with torch.no_grad():
        plain = TM.forward(cfg, p0, batch)
        rules = shd.ShardingRules(mesh, batch_size=2)
        p_sh = shd.distribute(p0, shd.param_specs(p0, mesh, fsdp=True),
                              mesh)
        b_sh = shd.distribute(batch, shd.batch_specs(batch, mesh, rules),
                              mesh)
        with rules.activate(), implicit_replication():
            got = TM.forward(cfg, p_sh, b_sh).full_tensor()
    return {"axes": list(mesh.mesh_dim_names), "shape": list(mesh.shape),
            "plain": plain.numpy(), "sharded": got.numpy()}
