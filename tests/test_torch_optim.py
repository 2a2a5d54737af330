"""The port's optimizers against the reference's: the same numpy
parameters and gradients go through ``repro.optim`` and
``repro_torch.optim`` for 20 steps.  Tolerance 1e-6 absolute on the
parameters: float32 on both sides, the same formulas, summed in another
order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import optim

STEPS = 20
ATOL = 1e-6


def _params_and_grads(seed, grad_scale):
    """A 2-D weight, a 1-D bias and a 0-d scalar (GIN's eps), with one
    gradient per step; ``grad_scale`` large makes the global-norm clip
    engage every step."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "eps": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32)
              for k, s in shapes.items()}
    grads = [{k: np.asarray(grad_scale * rng.standard_normal(s), np.float32)
              for k, s in shapes.items()} for _ in range(STEPS)]
    return params, grads


def _run_reference(opt, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        p, state = opt.apply(p, {k: jnp.asarray(v) for k, v in g.items()},
                             state)
    return {k: np.asarray(v) for k, v in p.items()}


def _run_port(make_opt, params, grads):
    p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()}
    opt = make_opt(list(p.values()))
    for g in grads:
        for k, t in p.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return {k: t.detach().numpy() for k, t in p.items()}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # clip off / on
@pytest.mark.parametrize("wd", [0.0, 0.1])              # decay 2-D only
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_reference(grad_scale, wd, schedule):
    params, grads = _params_and_grads(0, grad_scale)
    lr = ref_optim.cosine_schedule(1e-2, 3, STEPS) if schedule else 1e-2
    port_lr = optim.cosine_schedule(1e-2, 3, STEPS) if schedule else 1e-2
    ref = _run_reference(ref_optim.AdamW(lr=lr, weight_decay=wd), params,
                         grads)
    got = _run_port(lambda ps: optim.AdamW(ps, lr=port_lr, weight_decay=wd),
                    params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ATOL)
        assert not np.array_equal(got[k], params[k])


def test_adamw_clips_to_the_global_norm_and_spares_1d_params():
    """One step from zero moments: Adam's update is sign-like, so the
    clip shows in ``m`` (the first moment), and only the 2-D weight
    decays."""
    p = {"w": torch.nn.Parameter(torch.ones(2, 2)),
         "b": torch.nn.Parameter(torch.ones(2))}
    opt = optim.AdamW(list(p.values()), lr=0.1, weight_decay=0.5,
                      clip_norm=1.0)
    p["w"].grad = torch.zeros(2, 2)
    p["b"].grad = torch.tensor([30.0, 40.0])          # norm 50 -> clip 1/50
    opt.step()
    m_b = opt.state[p["b"]]["m"]
    np.testing.assert_allclose(m_b.numpy(), 0.1 * np.array([0.6, 0.8]),
                               rtol=1e-6)
    # w: zero gradient, so its whole step is the decay lr * wd * p
    np.testing.assert_allclose(p["w"].detach().numpy(), 1 - 0.1 * 0.5,
                               rtol=1e-6)
    # b: no decay, Adam's first step is lr * sign(g)
    np.testing.assert_allclose(p["b"].detach().numpy(), 1 - 0.1, rtol=1e-5)


def test_adamw_moves_a_param_without_gradient_like_jax_zeros():
    params, grads = _params_and_grads(1, 1.0)
    for g in grads[5:]:
        g["b"] = np.zeros_like(g["b"])
    ref = _run_reference(ref_optim.AdamW(lr=1e-2), params, grads)
    p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()}
    opt = optim.AdamW(list(p.values()), lr=1e-2)
    for i, g in enumerate(grads):
        for k, t in p.items():
            t.grad = (None if (k == "b" and i >= 5)
                      else torch.from_numpy(g[k].copy()))
        opt.step()
    for k in params:
        np.testing.assert_allclose(p[k].detach().numpy(), ref[k], rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    params, grads = _params_and_grads(2, 1.0)
    ref = _run_reference(ref_optim.Sgd(lr=1e-2, momentum=momentum), params,
                         grads)
    got = _run_port(lambda ps: optim.Sgd(ps, lr=1e-2, momentum=momentum),
                    params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ATOL)


def test_cosine_schedule_matches_reference():
    ref = ref_optim.cosine_schedule(3e-4, 10, 100)
    got = optim.cosine_schedule(3e-4, 10, 100)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        assert got(step) == pytest.approx(float(ref(jnp.asarray(step))),
                                          rel=1e-6, abs=1e-12)
