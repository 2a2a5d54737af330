"""Prefill against the decode-only serving loop, in the reference and in
the port, on the same weights and prompts in float32.

The two paths compute one function by two algorithms, so each package's
gap between them is its own roundoff; where the port's gap matches the
reference's, a larger gap at some width is the algorithm's, not the
port's.  The test holds both gaps to roundoff at the reduced configs
(2e-5 of the largest logit, the single-layer tolerance of
``test_torch_transformer.py``) and the two prefills to each other within
1e-4.  Run as a script, it prints the readings at any width and depth:

  PYTHONPATH=src python tests/test_torch_reference_gap.py \\
      --arch mamba2-780m --full-width --layers 2 --prompt-len 1024

(Zamba2-2.7B's cut keeps ``attn_every`` 6, so ``--layers`` is a multiple
of 6 at full width.)
"""
import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models.transformer import model as RM
from repro_torch.configs import base
from repro_torch.launch.prefill_gap import decode_loop, gap
from repro_torch.models.transformer import model as M


def reference_and_port_gaps(arch, *, full_width=False, layers=None,
                            batch=2, prompt_len=32, seed=0) -> dict:
    """Both packages' gaps (``prefill_gap.gap``'s keys) between prefill and
    the decode-only loop, and the gap between the two prefills, for
    ``arch`` at its published widths or reduced, cut to ``layers``."""
    rcfg, cfg = ref_base.get_config(arch), base.get_config(arch)
    if not full_width:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    kw = dict(param_dtype="float32", compute_dtype="float32")
    if layers:
        kw["num_layers"] = layers
    rcfg, cfg = rcfg.replace(**kw), cfg.replace(**kw)
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg,
                                                   jax.random.PRNGKey(seed)))
    rparams = jax.tree.map(jnp.asarray, tree)
    params = M.params_from_numpy(cfg, tree, device="cpu")
    tok = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    V = cfg.vocab_size
    t0 = time.perf_counter()

    rlg, _ = jax.jit(lambda p, b: RM.prefill(rcfg, p, b))(
        rparams, {"tokens": jnp.asarray(tok)})
    step = jax.jit(lambda p, c, b: RM.decode_step(rcfg, p, c, b))
    cache = RM.init_cache(rcfg, batch, prompt_len)
    for t in range(prompt_len):
        rdl, cache = step(rparams, cache,
                          {"token": jnp.asarray(tok[:, t:t + 1]),
                           "pos": jnp.asarray(t, jnp.int32)})
    rlg = torch.from_numpy(np.array(rlg, np.float32))[:, :V]
    rdl = torch.from_numpy(np.array(rdl, np.float32))[:, :V]

    with torch.inference_mode():
        tt = torch.from_numpy(tok)
        lg, _ = M.prefill(cfg, params, {"tokens": tt})
        dl = decode_loop(cfg, params, tt)
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "batch": batch, "prompt_len": prompt_len,
            "reference": gap(rlg, rdl), "port": gap(lg[:, :V], dl[:, :V]),
            "port_vs_reference_prefill": gap(lg[:, :V], rlg),
            "seconds": time.perf_counter() - t0}


@pytest.fixture
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ("phi3-mini-3.8b", "mamba2-780m",
                                  "zamba2-2.7b"))
def test_both_gaps_are_roundoff_at_the_reduced_configs(arch,
                                                       _two_torch_threads):
    r = reference_and_port_gaps(arch)
    assert r["reference"]["max_abs_rel"] <= 2e-5
    assert r["port"]["max_abs_rel"] <= 2e-5
    assert r["port_vs_reference_prefill"]["max_abs_rel"] <= 1e-4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)
    res = reference_and_port_gaps(a.arch, full_width=a.full_width,
                                  layers=a.layers, batch=a.batch,
                                  prompt_len=a.prompt_len, seed=a.seed)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
