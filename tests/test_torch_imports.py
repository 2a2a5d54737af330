"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the reference package (nor ``msgpack``, which the
reference's checkpoints use and the port's requirements lack), and a
CUDA request without a card raises instead of running on the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_every_submodule_imports_without_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for want in ('launch.serve_gnn', 'launch.train_gnn',\n"
        "             'optim', 'optim.adamw', 'core.scheduling',\n"
        "             'core.sampling', 'kernels.ops',\n"
        "             'kernels.flash_attention', 'kernels.ssd_chunk',\n"
        "             'configs.base', 'configs.phi3_mini_3_8b',\n"
        "             'configs.mamba2_780m', 'models.transformer.layers',\n"
        "             'models.transformer.attention',\n"
        "             'models.transformer.ssm',\n"
        "             'models.transformer.model', 'launch.serve',\n"
        "             'launch.prefill_gap', 'core.reordering',\n"
        "             'core.updates', 'graph.datasets', 'checkpoint',\n"
        "             'checkpoint.io', 'serving.replica',\n"
        "             'serving.router', 'configs.qwen2_5_14b',\n"
        "             'configs.gemma_7b', 'configs.glm4_9b',\n"
        "             'core.partitioning', 'core.sync', 'core.halo',\n"
        "             'core.collectives', 'core.propagation',\n"
        "             'core.coordination', 'distributed',\n"
        "             'distributed.pipeline', 'distributed.async_train',\n"
        "             'distributed.sampler', 'core.parallel',\n"
        "             'models.transformer.moe',\n"
        "             'configs.granite_moe_1b_a400m', 'examples',\n"
        "             'examples.quickstart', 'examples.serve_gnn',\n"
        "             'examples.serve_batched',\n"
        "             'examples.distributed_gnn',\n"
        "             'configs.deepseek_v3_671b',\n"
        "             'configs.whisper_tiny', 'configs.qwen2_vl_7b',\n"
        "             'data', 'data.pipeline', 'launch.train',\n"
        "             'examples.train_lm_100m',\n"
        "             'examples.whisper_vlm_smoke'):\n"
        "    assert 'repro_torch.' + want in names, (want, names)\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'msgpack')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[-1]) >= 40


def test_no_source_imports_jax_or_reference():
    found = []
    for path in _port_files():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            found += [(path, node.lineno, m) for m in mods
                      if m.split(".")[0] in FORBIDDEN]
    assert not found, found


def test_resolve_cuda_raises_without_a_card():
    from repro_torch import device
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve("cuda")
    with pytest.raises(RuntimeError):
        device.resolve()                      # cuda is the default
    assert device.resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
