"""The reference's side of the dry-run tests: the JAX package's sharding
specs and dry-run helpers for every architecture at full size, written
as JSON.

    python tests/torch_dryrun_reference.py OUT.json

Runs in a subprocess of its own with 512 forced host devices (set before
JAX starts, as ``repro.launch.dryrun`` does).  Nothing is allocated:
params and caches are ``jax.eval_shape``'d.  For every architecture it
writes, under ``archs[arch]``:

* ``param_specs[mesh][fsdp]``: ``{path: spec}`` of ``param_specs`` (the
  stacked leaves with their leading layer axis);
* per shape: the adapted config's fields, ``model_flops``, ``input_specs``
  (shape and dtype), and per mesh ``cache_specs``, ``batch_specs``,
  ``spec_for("act" / "logits")`` and ``arg_bytes``: the sum of the
  ``NamedSharding(...).shard_shape`` bytes of the step's arguments as
  ``build_lowerable`` places them (params, AdamW's m / v / step for
  ``train_4k``, batch, cache), with ``scalar_bytes`` the 0-d leaves'
  share (the step count, the decode position);

and ``shapes`` (``get_shape``) and ``skips`` (``SKIPS``).  A spec is a
list with one entry a dim: null, an axis name, or a list of names.
"""
import dataclasses
import json
import sys

from repro.launch import dryrun as D  # sets XLA_FLAGS first (512 devices)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs.base import ARCH_ALIASES, INPUT_SHAPES  # noqa: E402
from repro.data.pipeline import input_specs  # noqa: E402
from repro.launch import sharding as shd  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models.transformer import model as M  # noqa: E402
from repro.optim import AdamW  # noqa: E402


def spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def by_path(tree, fn):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]:
        out[shd._path_str(path)] = fn(leaf)
    return out


def shard_bytes(tree, specs, mesh):
    """(all bytes, 0-d leaves' bytes) of ``tree``'s shards."""
    total = scalars = 0
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for leaf, spec in zip(leaves, spec_leaves):
        n = int(np.prod(NamedSharding(mesh, spec).shard_shape(leaf.shape))
                ) * np.dtype(leaf.dtype).itemsize
        total += n
        if not leaf.shape:
            scalars += n
    return total, scalars


def main(out_path):
    meshes = {"16x16": make_production_mesh(multi_pod=False),
              "2x16x16": make_production_mesh(multi_pod=True)}
    result = {"skips": [[a, s, r] for (a, s), r in D.SKIPS.items()],
              "shapes": {n: dataclasses.asdict(s)
                         for n, s in INPUT_SHAPES.items()},
              "archs": {}}
    for arch in ARCH_ALIASES:
        base = D.get_config(arch)
        params4k = jax.eval_shape(lambda: M.init_params(
            base, jax.random.PRNGKey(0), max_seq=4096))
        entry = {"param_specs": {
            m: {str(f): by_path(shd.param_specs(params4k, mesh, fsdp=f),
                                spec_json)
                for f in (False, True)} for m, mesh in meshes.items()},
            "shapes": {}}
        for sname, shape in INPUT_SHAPES.items():
            cfg = D.adapt_config(base, shape)
            batch = input_specs(cfg, shape)
            one = {"config": {k: (list(v) if isinstance(v, tuple) else v)
                              for k, v in dataclasses.asdict(cfg).items()},
                   "model_flops": D.model_flops(cfg, shape),
                   "input_specs": {k: [list(v.shape), str(v.dtype)]
                                   for k, v in batch.items()},
                   "meshes": {}}
            params = jax.eval_shape(lambda: M.init_params(
                cfg, jax.random.PRNGKey(0), max_seq=shape.seq_len))
            cache = jax.eval_shape(lambda: M.init_cache(
                cfg, shape.global_batch, shape.seq_len,
                enc_len=shape.seq_len))
            train = shape.kind == "train"
            for m, mesh in meshes.items():
                rules = shd.ShardingRules(mesh, batch_size=shape.global_batch,
                                          fsdp=False)
                c_specs = shd.cache_specs(cache, mesh, rules)
                b_specs = shd.batch_specs(batch, mesh, rules)
                p_specs = shd.param_specs(params, mesh, fsdp=train)
                total, scalars = shard_bytes(params, p_specs, mesh)
                parts = [shard_bytes(batch, b_specs, mesh)]
                if train:
                    opt = jax.eval_shape(AdamW(lr=1e-4).init, params)
                    for k in ("m", "v"):
                        parts.append(shard_bytes(opt[k], p_specs, mesh))
                    parts.append(shard_bytes(
                        opt["step"], jax.sharding.PartitionSpec(), mesh))
                elif shape.kind == "decode":
                    parts.append(shard_bytes(cache, c_specs, mesh))
                for t, s in parts:
                    total, scalars = total + t, scalars + s
                B, S = shape.global_batch, shape.seq_len
                Sq = 1 if shape.kind == "decode" else S
                one["meshes"][m] = {
                    "cache_specs": by_path(c_specs, spec_json),
                    "batch_specs": by_path(b_specs, spec_json),
                    "act": spec_json(rules.spec_for(
                        "act", (B, Sq, cfg.d_model))),
                    "logits": spec_json(rules.spec_for(
                        "logits", (B, Sq, cfg.padded_vocab))),
                    "arg_bytes": total, "scalar_bytes": scalars}
            entry["shapes"][sname] = one
        result["archs"][arch] = entry
    with open(out_path, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1])
