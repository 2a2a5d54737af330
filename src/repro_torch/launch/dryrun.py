"""Sharding-plan dry run (the reference's ``launch/dryrun.py``): prove the
distribution config is coherent without hardware.  For every
(architecture x input shape x mesh) this builds the step the shape
calls for on DTensors over a fake process group of 256 or 512 ranks
(``launch/mesh.py``), its parameters, AdamW state, batch and cache
placed by the reference's sharding rules (``launch/sharding.py``), and
runs it once under ``FakeTensorMode``: nothing is allocated and no
device is touched (on a machine with a card, CUDA is never even
initialised).  It reports per-device memory, FLOPs and collective
bytes by kind, and a roofline against the H100's datasheet figures
(``launch/comm_analysis.py``): plan estimates, not measured times.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --shape train_4k [--multi-pod] [--both-meshes] [--all] [--json out] \\
      [--save-log collectives.json]

(``--save-log``, the reference's ``--save-hlo``: the first variant's
collectives, each with its kind, mesh axis and bytes.)

Steps: ``train_4k`` a train step with AdamW and per-layer remat,
``prefill_32k`` a prefill, ``decode_32k`` / ``long_500k`` one decode step
against a full cache.

The counts come from running 1- and 2-layer variants of each layer stack
and fitting ``cost = c0 + sum_i n_i * body_i`` (:func:`extrapolated_costs`,
the reference's method): the eager step counts every layer, so the fit
is exact for FLOPs and bytes, and it spares running 61 layers of
DeepSeek-V3.  The result keys are the reference's ``run_one``'s; those
that name XLA artefacts have torch names:

* ``lower_s`` / ``compile_s`` -> ``trace_s`` (seconds of the variants'
  fake runs);
* ``hlo_flops_total`` -> ``flops_total`` (``flops_per_device`` x chips);
* ``raw_uncorrected`` -> ``variant_costs`` (each variant's counts).

``bytes_per_device`` is the peak of live local-shard bytes the counter
saw (arguments included), ``temp_bytes`` that peak less
``arg_bytes``, the sum of the arguments' local shard bytes (parameters,
AdamW's float32 ``m`` and ``v``, batch, cache); the peak is extrapolated
like the costs.  ``flops_per_device`` counts the matrix products on the
local shards; ``hbm_bytes_per_device`` every local op's inputs and
outputs, unfused.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import (
    ARCH_ALIASES, INPUT_SHAPES, get_config, get_shape)
from repro_torch.data.pipeline import input_specs
from repro_torch.launch import comm_analysis as CA
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.models.transformer import model as M

SKIPS = {
    # (arch, shape): reason
    ("whisper-tiny", "long_500k"):
        "enc-dec cross-attention has no sliding-window/sub-quadratic variant",
}

ATTENTION_FAMILIES = ("dense", "vlm", "moe", "mla_moe")
LONG_WINDOW = 8192


def adapt_config(cfg, shape):
    """Shape-conditional config tweaks (sliding window for long decode)."""
    if shape.name == "long_500k" and cfg.family in ATTENTION_FAMILIES:
        cfg = cfg.replace(sliding_window=LONG_WINDOW)
    if shape.name == "long_500k" and cfg.family == "hybrid":
        # zamba2's shared attention blocks also ring-buffer at 500k
        cfg = cfg.replace(sliding_window=LONG_WINDOW)
    return cfg


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, PRODUCTION_SHAPES[multi_pod][0]))


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _leaves(tree):
    """The tensors of a tree of dicts and lists (other leaves dropped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return []


def build_step(cfg, shape, mesh):
    """The step of ``shape`` on DTensors over ``mesh`` (call it under a
    ``FakeTensorMode``), as the reference's defaults build it: FSDP for
    training only, sequence parallelism, per-layer remat.  Returns ``(fn, args)``: ``fn()`` runs the step
    with the rules active; ``args`` holds the step's distributed inputs
    (``params``, AdamW's ``opt_state`` ``{m, v}`` in float32 with the
    parameters' placements, ``batch``, ``cache``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.optim import AdamW

    rules = shd.ShardingRules(mesh, batch_size=shape.global_batch)
    batch_meta = input_specs(cfg, shape)
    pos = batch_meta.pop("pos", None)
    batch = shd.distribute(batch_meta, shd.batch_specs(batch_meta, mesh,
                                                       rules), mesh)
    if pos is not None:
        # decode against a full cache: the last position (a real int,
        # read on the host)
        batch["pos"] = shape.seq_len - 1

    params_meta = M.init_params(cfg, torch.Generator(), device="meta",
                                max_seq=shape.seq_len)
    train = shape.kind == "train"
    p_specs = shd.param_specs(params_meta, mesh, fsdp=train)
    params = shd.distribute(params_meta, p_specs, mesh, requires_grad=train)
    args = {"params": params, "batch": batch}

    if train:
        leaves = M.trainable(params)
        opt = AdamW(leaves, lr=1e-4)
        moments = {}
        for name in ("m", "v"):
            f32 = shd.map_tree(
                lambda t: torch.empty(t.shape, dtype=torch.float32,
                                      device="meta"), params_meta)
            moments[name] = shd.distribute(f32, p_specs, mesh)
        for p, m, v in zip(leaves, _leaves(moments["m"]),
                           _leaves(moments["v"])):
            opt.state[p] = {"step": 0, "m": m, "v": v}
        args["opt_state"] = moments
        step_fn = M.make_train_step(cfg, opt)

        def run():
            return step_fn(params, batch)
    elif shape.kind == "prefill":
        def run():
            return M.prefill(cfg, params, batch)
    else:
        cache_meta = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  enc_len=shape.seq_len, device="meta")
        cache = shd.distribute(cache_meta, shd.cache_specs(cache_meta, mesh,
                                                           rules), mesh)
        args["cache"] = cache

        def run():
            return M.decode_step(cfg, params, cache, batch)

    def fn():
        with rules.activate(), implicit_replication():
            if train:
                return run()
            with torch.no_grad():
                return run()

    return fn, args


# ---------------------------------------------------------------------------
# structural cost extrapolation
#
# The eager step counts every op of every layer, so a full-depth run
# would count exactly; the variants spare running every layer of the
# deep configs.  We run tiny variants (1 and 2 instances of each layer
# stack), fit the exactly-determined linear model
#     cost(variant) = c0 + sum_i n_i(variant) * body_i
# and report  cost(full) = c0 + sum_i N_i * body_i.
# Optimizer/grad-collective work on per-layer params is linear in L, so it
# is absorbed by the body coefficients; embed/lm-head/loss land in c0.
# ---------------------------------------------------------------------------

def _variant_cfgs(cfg):
    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "ssm"):
        stacks = {"layer": cfg.num_layers}
        variants = [
            ({"layer": 1}, cfg.replace(num_layers=1)),
            ({"layer": 2}, cfg.replace(num_layers=2)),
        ]
    elif fam == "mla_moe":
        stacks = {"dense": cfg.first_dense_layers,
                  "moe": cfg.num_layers - cfg.first_dense_layers}
        variants = [
            ({"dense": 1, "moe": 1},
             cfg.replace(num_layers=2, first_dense_layers=1)),
            ({"dense": 2, "moe": 1},
             cfg.replace(num_layers=3, first_dense_layers=2)),
            ({"dense": 1, "moe": 2},
             cfg.replace(num_layers=3, first_dense_layers=1)),
        ]
    elif fam == "hybrid":
        ng = cfg.num_layers // cfg.attn_every
        stacks = {"mamba": cfg.num_layers, "attn": ng}
        variants = [
            ({"mamba": 1, "attn": 1},
             cfg.replace(num_layers=1, attn_every=1)),
            ({"mamba": 2, "attn": 1},
             cfg.replace(num_layers=2, attn_every=2)),
            ({"mamba": 2, "attn": 2},
             cfg.replace(num_layers=2, attn_every=1)),
        ]
    elif fam == "encdec":
        stacks = {"enc": cfg.encoder_layers, "dec": cfg.num_layers}
        variants = [
            ({"enc": 1, "dec": 1},
             cfg.replace(num_layers=1, encoder_layers=1)),
            ({"enc": 2, "dec": 1},
             cfg.replace(num_layers=1, encoder_layers=2)),
            ({"enc": 1, "dec": 2},
             cfg.replace(num_layers=2, encoder_layers=1)),
        ]
    else:
        raise ValueError(fam)
    return stacks, variants


def arg_bytes(args) -> int:
    """The bytes of one device's shards of the step's arguments
    (:func:`build_step`'s ``args``; a Python int, the decode position,
    holds none)."""
    return sum(t.to_local().numel() * t.element_size()
               for t in _leaves(args))


def _measure(cfg, shape, mesh) -> dict:
    """One fake run of the step: its counts (``flops``, ``hbm_bytes``,
    ``coll/<kind>``, ``coll_s``), ``arg_bytes`` and ``peak_bytes``."""
    with _fake_mode():
        fn, args = build_step(cfg, shape, mesh)
        nbytes = arg_bytes(args)
        counter = CA.CostCounter(CA.group_axes(mesh))
        counter.track(*(t.to_local() for t in _leaves(args)))
        with CA.propagation_apart(), counter, CA.alltoall_as_alltoall():
            fn()
        peak = counter.peak_bytes
    out = counter.summary()
    out["coll_s"] = CA.collective_seconds(counter.coll_by_axis,
                                          shd.axis_sizes(mesh))
    out["arg_bytes"] = float(nbytes)
    out["peak_bytes"] = float(max(peak, nbytes))
    out["log"] = counter.log
    return out


def extrapolated_costs(cfg, shape, mesh) -> dict:
    stacks, variants = _variant_cfgs(cfg)
    names = list(stacks)
    rows, costs = [], []
    for counts, vcfg in variants:
        rows.append([1.0] + [float(counts[n]) for n in names])
        c = _measure(vcfg, shape, mesh)
        c.pop("log")
        costs.append(c)
    keys = set()
    for c in costs:
        keys.update(c)
    A = np.asarray(rows)
    full = np.asarray([1.0] + [float(stacks[n]) for n in names])
    out = {}
    for k in keys:
        y = np.asarray([c.get(k, 0.0) for c in costs])
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        out[k] = float(max(0.0, full @ coef))
    out["variant_costs"] = costs
    return out


def model_flops(cfg, shape) -> float:
    """6*N*D with N = active params (MoE: active experts only)."""
    params = M.init_params(cfg, torch.Generator(), device="meta",
                           max_seq=min(shape.seq_len, 4096))
    total = sum(int(np.prod(x.shape)) for x in M._leaves(params))
    if cfg.num_experts:
        # subtract inactive routed-expert params from the 6*N*D count
        def moe_leaves(t):
            out = []

            def rec(d, path):
                if isinstance(d, list):
                    for v in d:
                        rec(v, path)
                    return
                for k, v in d.items():
                    if isinstance(v, (dict, list)):
                        rec(v, path + (k,))
                    elif "moe" in path and k in ("w_in", "w_gate", "w_out"):
                        out.append(v)
            rec(t, ())
            return out
        inactive = 0
        for leaf in moe_leaves(params):
            E = cfg.num_experts
            frac = (E - cfg.experts_per_token) / E
            inactive += int(np.prod(leaf.shape)) * frac
        total -= inactive
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * total * tokens


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            save_log: str = "") -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if (cfg.name, shape_name) in SKIPS:
        return {"arch": cfg.name, "shape": shape_name,
                "mesh": mesh_name(multi_pod),
                "status": "SKIP", "reason": SKIPS[(cfg.name, shape_name)]}
    cfg = adapt_config(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    nchips = int(np.prod(mesh.shape))

    t0 = time.time()
    corr = extrapolated_costs(cfg, shape, mesh)
    t_trace = time.time() - t0
    if save_log:
        first = _measure(_variant_cfgs(cfg)[1][0][1], shape, mesh)
        with open(save_log, "w") as f:
            json.dump({"variant": 0, "collectives": first["log"]}, f)

    flops_per_dev = corr["flops"]
    bytes_per_dev = corr["hbm_bytes"]
    coll = {k.split("/", 1)[1]: v for k, v in corr.items()
            if k.startswith("coll/")}
    flops_total = flops_per_dev * nchips
    mf = model_flops(cfg, shape)
    arg_bytes = corr["arg_bytes"]
    peak = max(corr["peak_bytes"], arg_bytes)

    compute_s = flops_per_dev / CA.PEAK_FLOPS
    memory_s = bytes_per_dev / CA.HBM_BW
    coll_s = corr["coll_s"]
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]

    return {
        "arch": cfg.name, "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "status": "OK",
        "chips": nchips,
        "trace_s": round(t_trace, 1),
        "bytes_per_device": int(round(peak)),
        "temp_bytes": int(round(peak - arg_bytes)),
        "arg_bytes": int(round(arg_bytes)),
        "flops_per_device": flops_per_dev,
        "flops_total": flops_total,
        "model_flops": mf,
        "useful_ratio": round(mf / flops_total, 4) if flops_total else None,
        "hbm_bytes_per_device": bytes_per_dev,
        "collective_bytes_per_device": coll,
        "variant_costs": corr["variant_costs"],
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": coll_s,
            "dominant": dominant,
        },
    }


def _where(e: BaseException) -> str:
    """The innermost frames of the port, and the innermost of all, of an
    exception's traceback (``file:line``)."""
    import traceback
    frames = traceback.extract_tb(e.__traceback__)
    mine = [f for f in frames if "repro_torch" in f.filename][-3:]
    return ", ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                     for f in mine + frames[-1:])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default="")
    ap.add_argument("--save-log", default="",
                    help="write the first variant's collective log (kind, "
                         "mesh axis, bytes) as JSON here")
    args = ap.parse_args(argv)

    import logging
    import torch.distributed as dist
    from repro_torch.launch.mesh import start_fake_world
    # DTensor warns about its CPU all-to-all fallback (the counter books
    # it as an all-to-all) and about all-reduces over two mesh axes in turn
    for name in ("_collective_utils", "_redistribute"):
        logging.getLogger(f"torch.distributed.tensor.{name}").setLevel(
            logging.ERROR)

    combos = []
    archs = list(ARCH_ALIASES) if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                combos.append((a, s, mp))

    results = []
    failed = 0
    for mp in dict.fromkeys(m for _, _, m in combos):
        started = start_fake_world(int(np.prod(PRODUCTION_SHAPES[mp][0])))
        try:
            for a, s, m in combos:
                if m != mp:
                    continue
                tag = f"{a} x {s} x {mesh_name(mp)}"
                try:
                    r = run_one(a, s, multi_pod=mp, save_log=args.save_log)
                    results.append(r)
                    if r["status"] == "OK":
                        rf = r["roofline"]
                        print(f"OK   {tag}: mem/dev="
                              f"{r['bytes_per_device']/2**30:.2f}"
                              f"GiB flops/dev={r['flops_per_device']:.3e} "
                              f"useful={r['useful_ratio']} "
                              f"dominant={rf['dominant']} "
                              f"(C={rf['compute_s']:.4f}s "
                              f"M={rf['memory_s']:.4f}s "
                              f"X={rf['collective_s']:.4f}s) "
                              f"trace={r['trace_s']}s", flush=True)
                    else:
                        print(f"SKIP {tag}: {r['reason']}", flush=True)
                except Exception as e:  # noqa: BLE001
                    failed += 1
                    print(f"FAIL {tag}: {type(e).__name__}: {e} "
                          f"(at {_where(e)})", flush=True)
                    results.append({"arch": a, "shape": s,
                                    "mesh": mesh_name(mp),
                                    "status": "FAIL",
                                    "error": str(e)[:500]})
        finally:
            if started:
                dist.destroy_process_group()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(f"done: {sum(r['status'] == 'OK' for r in results)} ok, "
          f"{sum(r['status'] == 'SKIP' for r in results)} skip, "
          f"{failed} fail")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
