"""The port's examples (``repro_torch/examples``) on the CPU: quickstart's
numbers against the reference example's steps run on the reference's
modules (replication factors, balance, the samplers' input counts, the
2-hop growth and the cache hit ratios exactly equal; the GCN, trained
from the port's own initial parameters, above the example's 0.9
accuracy), ``serve_batched`` and ``serve_gnn`` exiting 0, and
``distributed_gnn``'s ``--minibatch`` run and one ``--fullgraph`` run.
Without a card, each example's default device raises."""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import caching as RCA
from repro.core import partitioning as RP
from repro.core import sampling as RSA
from repro.graph import generators as RG
from repro_torch.examples import distributed_gnn, quickstart

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = ("serve_batched", "serve_gnn", "quickstart", "distributed_gnn")


def _reference_quickstart() -> dict:
    """The reference example's partitioning, sampling and caching steps
    (``examples/quickstart.py``), on the reference's modules."""
    g = RG.featurize(RG.sbm(600, 4, p_in=0.9, p_out=0.02, seed=0), 32,
                     seed=0, class_sep=1.5)
    out = {"partitioners": {}, "sampler_inputs": {}, "cache_hit_ratio": {}}
    for method in ("hash", "ldg", "hdrf"):
        p = RP.partition(g, 4, method)
        out["partitioners"][method] = {
            "replication_factor": p.replication_factor(g),
            "balance": p.balance()}
    seeds = np.arange(32)
    out["growth"] = RSA.neighborhood_growth(g, seeds, hops=2)
    for name, s in [
            ("neighbor (GraphSAGE)", RSA.NeighborSampler(g, [5, 5], seed=0)),
            ("layer-wise (FastGCN)",
             RSA.LayerWiseSampler(g, [64, 64], dependent=False, seed=0)),
            ("layer-dep (LADIES)",
             RSA.LayerWiseSampler(g, [64, 64], dependent=True, seed=0))]:
        mb = s.sample(seeds)
        out["sampler_inputs"][name] = int((mb.blocks[0].src_nodes >= 0).sum())
    s = RSA.NeighborSampler(g, [5, 5], seed=0)
    rng = np.random.default_rng(0)
    batches = [s.sample(rng.choice(g.num_nodes, 32, replace=False))
               .input_nodes for _ in range(10)]
    for policy in ("random", "degree"):
        out["cache_hit_ratio"][policy] = RCA.measure_cache(
            g, policy, g.num_nodes // 10, batches)["hit_ratio"]
    return out


def test_quickstart_numbers_equal_the_reference_example():
    got = quickstart.main(["--device", "cpu"])
    want = _reference_quickstart()
    for key in ("partitioners", "sampler_inputs", "growth",
                "cache_hit_ratio"):
        assert got[key] == want[key], key
    assert got["growth"][0] == 32 and got["growth"][-1] > 32
    assert got["accuracy"] > 0.9 and np.isfinite(got["loss"])


@pytest.mark.parametrize("name", ["serve_batched", "serve_gnn"])
def test_serving_examples_exit_zero_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cpu"], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"{name} " in out.stdout and "OK" in out.stdout


@pytest.mark.parametrize("which", ["fullgraph", "minibatch"])
def test_distributed_example_runs_on_the_cpu(which):
    """One ``--fullgraph`` run (4 ranks, fp32 ghosts) or the
    ``--minibatch`` run (4 ranks, SAGE) of the example's six."""
    runs = [r for r in distributed_gnn.RUNS if f"--{which}" in r][:1]
    (res,) = distributed_gnn.run(runs, "cpu")
    assert len(res["ranks"]) == 4
    assert all(np.isfinite(r["losses"]).all() for r in res["ranks"])


def test_distributed_example_keeps_the_reference_runs():
    """The six argument lists of the reference's example, grouped into
    one world a size in order."""
    assert [distributed_gnn._world(r) for r in distributed_gnn.RUNS] == \
        [8, 8, 8, 4, 4, 4]
    assert sum("--minibatch" in r for r in distributed_gnn.RUNS) == 1
    assert sum("--fullgraph" in r for r in distributed_gnn.RUNS) == 2


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_the_card(name):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
