"""Ten steps of the port's transformer trainer against ten of the
reference's, on identical numpy parameters and corpus batches, at the
reduced configs in float32, for every family ``launch.train`` trains:
``make_train_step`` (``src/repro/models/transformer/model.py:310``)
with the port's optimizers against the reference's
(``src/repro/optim/adamw.py``), the loss and grad norm of each step and
every parameter after the tenth within 1e-5 of its tensor's largest
reference value.

The parameters are held under the reference's SGD, and AdamW (with
``cosine_schedule``) at its first step's loss and grad norm, as the GNN
trainers' tests hold GIN and GGNN.  Adam divides each gradient element
by its own running magnitude, so an element whose gradient is mostly
roundoff steps by up to +-lr in a direction the roundoff picks, and the
two frameworks' roundoff differ: embedding rows whose contributions
cancel to ~1e-8 (Adam's eps) drift apart at once (6.2e-6 after one
AdamW step in Mamba2's table, whose largest value is 0.09), and Qwen2.5's
and GLM-4's key bias has a gradient that is zero but for roundoff
(softmax ignores a shift shared by all of a row's keys).  After ten
AdamW steps every family's embedding table lay 1e-3 to 1.2e-1 of its
largest value from the reference's on this test's CPU run, where SGD,
whose step is linear in the gradient, keeps the two within 1e-5.  SGD
runs at lr 0.01: at 0.1 the reduced models' unclipped steps (gradient
norms 8 to 19) are large enough that float32 trajectories separate by
themselves (DeepSeek's embedding table 3.7e-5 of its largest value from
the reference's after ten steps, growing about 1.8x a step from the
seventh, with every router's top-k margin above 2.8e-4, no near-tie).

One leaf has its own bound: the SSM families' ``dt_bias`` (zeros at
init, so its largest value after ten steps is their sum, 1.5e-3 in
Zamba2), whose gradient runs through the SSD's decays, exponentials of
differences of running sums.  The reference's own ten steps, jitted and
run op by op, differ there by 5.3e-6 of that largest value (2.0e-6 in
Mamba2) on this test's CPU; the port sat at 1.3e-5 from the reference's
jitted run in Zamba2, so the leaf is held to 3e-5, about 6x the
reference's own spread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import model as RM
from repro.optim import AdamW as RAdamW
from repro.optim import Sgd as RSgd
from repro.optim import cosine_schedule as rcosine
from repro_torch.data import pipeline as P
from repro_torch.models.transformer import model as M
from repro_torch.optim import AdamW, Sgd, cosine_schedule
from test_torch_lm_train import (S, B, assert_trees_close, reference_model,
                                 stacked)

STEPS = 10
TRAINED = ("qwen2.5-14b", "phi3-mini-3.8b", "gemma-7b", "glm4-9b",
           "granite-moe-1b-a400m", "deepseek-v3-671b", "mamba2-780m",
           "zamba2-2.7b")
LR, WARMUP, SGD_LR = 3e-3, 3, 0.01
# the one leaf with its own bound (module docstring)
DT_BIAS_REL = {"['layers']['ssm']['dt_bias']": 3e-5}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run_both(arch, opt_name, steps):
    rcfg, tree, cfg, params = reference_model(arch)
    it = P.SyntheticLMDataset(cfg.vocab_size, S, seed=1).batches(B)
    batches = [next(it) for _ in range(steps)]
    if opt_name == "adamw":
        ropt = RAdamW(lr=rcosine(LR, WARMUP, steps), weight_decay=0.01)
        opt = AdamW(M.trainable(params), lr=cosine_schedule(LR, WARMUP,
                                                            steps),
                    weight_decay=0.01)
    else:
        ropt, opt = RSgd(lr=SGD_LR), Sgd(M.trainable(params), lr=SGD_LR)
    rstep = jax.jit(RM.make_train_step(rcfg, ropt, remat=False))
    rparams = jax.tree.map(jnp.asarray, tree)
    ostate = ropt.init(rparams)
    step = M.make_train_step(cfg, opt)
    got, want = [], []
    for b in batches:
        rparams, ostate, rm = rstep(rparams, ostate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        m = step(params, {k: torch.from_numpy(v) for k, v in b.items()})
        want.append((float(rm["loss"]), float(rm["grad_norm"])))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    return got, want, params, rparams


@pytest.mark.parametrize("arch", TRAINED)
def test_ten_steps_match_the_reference(arch):
    """Ten SGD steps: every loss and grad norm, every parameter after the
    last; AdamW's first step: its loss."""
    got, want, params, rparams = _run_both(arch, "sgd", STEPS)
    for (l, g), (rl, rg) in zip(got, want):
        assert l == pytest.approx(rl, rel=1e-5)
        assert g == pytest.approx(rg, rel=1e-5)
    assert_trees_close(stacked(params), jax.tree.map(np.asarray, rparams),
                       rel_by_path=DT_BIAS_REL)
    got, want, _, _ = _run_both(arch, "adamw", 1)
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-5)
