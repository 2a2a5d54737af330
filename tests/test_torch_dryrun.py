"""The sharding-plan dry run (``repro_torch.launch.{sharding,dryrun,
comm_analysis,mesh}``) against the reference's: the sharding specs of
every architecture at full size on both production meshes, the dry
run's helpers (``get_shape``, ``input_specs``, ``adapt_config``,
``SKIPS``, ``model_flops``), the collective counter on a known
redistribution, and per-layer remat against none.

The reference runs once in a subprocess with 512 forced host devices
(``tests/torch_dryrun_reference.py``); the port's side runs here on fake
process groups, no device touched.  The argument bytes of the 2x16x16
mesh are held in ``tests/test_torch_dryrun_pods.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (ARCH_ALIASES, INPUT_SHAPES, get_config,
                                      get_shape)
from repro_torch.data.pipeline import input_specs
from repro_torch.launch import dryrun as DR
from repro_torch.launch import sharding as shd
from repro_torch.models.transformer import model as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ARCHS = list(ARCH_ALIASES)


def reference_specs(tmp_path_factory) -> dict:
    out = tmp_path_factory.mktemp("dryrun_ref") / "specs.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "tests", "torch_dryrun_reference.py"), str(out)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_specs(tmp_path_factory)


def norm(spec) -> list:
    """A spec as the reference's ``PartitionSpec`` reads: one entry a dim,
    a one-axis tuple as its axis."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else list(e)
        out.append(e)
    return out


def port_arg_bytes(mesh_name: str) -> dict:
    """``{(arch, shape): arg_bytes}`` of the port's ``build_step`` on a
    fake world of the mesh's size (started and destroyed here)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16")
    out = {}
    try:
        for arch in ARCHS:
            for sname, shape in INPUT_SHAPES.items():
                cfg = DR.adapt_config(get_config(arch), shape)
                with DR._fake_mode():
                    _, args = DR.build_step(cfg, shape, mesh)
                    out[arch, sname] = DR.arg_bytes(args)
    finally:
        dist.destroy_process_group()
    return out


def check_arg_bytes(ref, got, mesh_name):
    """The port's argument bytes equal the sum of the reference's shard
    shapes, less its 0-d leaves (the optimizer's step count and the
    decode position, host ints in the port)."""
    for (arch, sname), nbytes in got.items():
        want = ref["archs"][arch]["shapes"][sname]["meshes"][mesh_name]
        assert nbytes == want["arg_bytes"] - want["scalar_bytes"], \
            (arch, sname, mesh_name)


@pytest.fixture(scope="module")
def arg_bytes_16x16():
    return port_arg_bytes("16x16")


def _stacked(path: str) -> bool:
    return shd.rule_path(path) != path


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(ref, arch, arg_bytes_16x16):
    """Every leaf's ``param_specs`` (both meshes, FSDP on and off: a
    layer's leaf takes the reference's stacked spec without its layer
    axis, and every reference leaf has a port leaf), ``cache_specs``,
    ``batch_specs`` and ``spec_for("act" / "logits")`` of every shape,
    and the 16x16 mesh's argument bytes."""
    r = ref["archs"][arch]
    base = get_config(arch)
    params = M.init_params(base, torch.Generator(), device="meta")
    for mname, sizes in MESHES.items():
        for fsdp in (False, True):
            want = r["param_specs"][mname][str(fsdp)]
            got = {}
            shd.map_with_path(lambda p, t: got.__setitem__(
                p, shd.param_spec(p, tuple(t.shape), sizes, fsdp=fsdp)),
                params)
            seen = set()
            for path, spec in got.items():
                key = shd.rule_path(path)
                w = want[key][1:] if _stacked(path) else want[key]
                assert norm(spec) == norm(w), (mname, fsdp, path)
                seen.add(key)
            assert seen == set(want), (mname, fsdp)
    for sname, shape in INPUT_SHAPES.items():
        cfg = DR.adapt_config(base, shape)
        batch = input_specs(cfg, shape)
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                             enc_len=shape.seq_len, device="meta")
        for mname, sizes in MESHES.items():
            want = r["shapes"][sname]["meshes"][mname]
            rules = shd.ShardingRules(sizes, batch_size=shape.global_batch)
            for kind, tree, fn in (("cache_specs", cache, shd.cache_specs),
                                   ("batch_specs", batch, shd.batch_specs)):
                got = {}
                shd.map_with_path(got.__setitem__, fn(tree, sizes, rules))
                assert {k: norm(v) for k, v in got.items()} == \
                    {k: norm(v) for k, v in want[kind].items()}, \
                    (sname, mname, kind)
            B, S = shape.global_batch, shape.seq_len
            Sq = 1 if shape.kind == "decode" else S
            assert norm(rules.spec_for("act", (B, Sq, cfg.d_model))) == \
                norm(want["act"])
            assert norm(rules.spec_for("logits", (B, Sq, cfg.padded_vocab))
                        ) == norm(want["logits"])
    check_arg_bytes(ref, {k: v for k, v in arg_bytes_16x16.items()
                          if k[0] == arch}, "16x16")


@pytest.mark.parametrize("arch", ARCHS)
def test_helpers_match_the_reference(ref, arch):
    """``get_shape``, ``input_specs`` (shapes and dtypes), ``adapt_config``
    (every field the port has), ``model_flops`` and ``SKIPS`` equal the
    reference's for every shape."""
    assert [[a, s, why] for (a, s), why in DR.SKIPS.items()] == ref["skips"]
    base = get_config(arch)
    for sname in INPUT_SHAPES:
        shape = get_shape(sname)
        assert dataclasses.asdict(shape) == ref["shapes"][sname]
        want = ref["archs"][arch]["shapes"][sname]
        cfg = DR.adapt_config(base, shape)
        got = {k: (list(v) if isinstance(v, tuple) else v)
               for k, v in dataclasses.asdict(cfg).items()}
        assert got == {k: want["config"][k] for k in got}, sname
        assert {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                for k, v in input_specs(cfg, shape).items()} == \
            want["input_specs"]
        assert DR.model_flops(cfg, shape) == want["model_flops"], sname


def test_collective_counter_books_a_known_redistribution():
    """On a fake 2x2 mesh: an all-gather of bf16 (8, 128), an all-reduce
    of 16 float32, two reduce-scatters to f32 (4, 4) and an all-to-all of
    a bf16 (2, 8) shard give those bytes by kind and mesh axis, as the
    reference's ``collective_bytes`` does for the HLO ops; the CPU
    all-to-all fallback counts as one all-to-all."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from repro_torch.launch import comm_analysis as CA
    from repro_torch.launch.mesh import start_fake_world
    assert start_fake_world(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

        def dt(shape, pl, dtype=torch.float32):
            return DTensor.from_local(torch.empty(shape, dtype=dtype), mesh,
                                      pl, run_check=False)

        with DR._fake_mode():
            counter = CA.CostCounter(CA.group_axes(mesh))
            with CA.propagation_apart(), counter, CA.alltoall_as_alltoall():
                dt((4, 128), [Replicate(), Shard(0)], torch.bfloat16
                   ).redistribute(mesh, [Replicate(), Replicate()])
                dt((16,), [Partial(), Replicate()]).redistribute(
                    mesh, [Replicate(), Replicate()])
                for _ in range(2):
                    dt((8, 4), [Replicate(), Partial()]).redistribute(
                        mesh, [Replicate(), Shard(0)])
                dt((2, 8), [Replicate(), Shard(0)], torch.bfloat16
                   ).redistribute(mesh, [Replicate(), Shard(1)])
    finally:
        dist.destroy_process_group()
    got = dict(counter.coll)
    assert got["all-gather"] == 8 * 128 * 2
    assert got["all-reduce"] == 16 * 4
    assert got["reduce-scatter"] == 2 * 16 * 4
    assert got["all-to-all"] == 2 * 8 * 2
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    assert dict(counter.coll_by_axis) == {
        ("all-gather", "model"): 2048, ("all-reduce", "data"): 64,
        ("reduce-scatter", "model"): 128, ("all-to-all", "model"): 32}


def _lm_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    batch = {"tokens": tok, "labels": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "vlm":
        batch = {"embeds": torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model), np.float32)),
            "positions": torch.arange(S)[None, None].expand(3, B, S),
            "labels": batch["labels"]}
    elif cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model), np.float32))
    return batch


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-780m",
                                  "zamba2-2.7b", "granite-moe-1b-a400m",
                                  "deepseek-v3-671b", "whisper-tiny",
                                  "qwen2-vl-7b"])
def test_remat_is_bitwise(arch):
    """``loss_fn(remat=True)`` (each layer under
    ``torch.utils.checkpoint``) gives the loss and every gradient of
    ``remat=False`` bit for bit on the CPU."""
    cfg = get_config(arch).reduced()
    out = []
    for remat in (False, True):
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        leaves = M.trainable(params)
        loss = M.loss_fn(cfg, params, _lm_batch(cfg, 2, 32, 1), remat=remat)
        loss.backward()
        out.append([loss.detach()] + [p.grad for p in leaves])
    for a, b in zip(*out):
        assert (a is None and b is None) or torch.equal(a, b)
