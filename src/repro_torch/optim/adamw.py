"""Optimizers with the reference's semantics (``src/repro/optim/adamw.py``).

:class:`AdamW` differs from ``torch.optim.AdamW`` in the three ways the
reference does: the gradients of every parameter are first clipped to a
global norm (``min(1, clip_norm / (||g|| + 1e-9))``), the second-moment
decay defaults to ``b2 = 0.95``, and the decoupled weight decay
``u + wd * p`` applies only to parameters with ``ndim >= 2`` (no decay on
biases, norms and scalars).  Moments are float32 whatever the parameter
dtype; bias correction uses the step count.

A parameter that received no gradient (``grad is None``) is updated as
if its gradient were zero, as ``jax.grad`` gives zeros for it: its
moments still decay and Adam's momentum still moves it.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Union

import torch

LR = Union[float, Callable[[int], float]]


def _on_host():
    """Host scalars (bias corrections, the schedule) are real tensors
    even under a ``FakeTensorMode`` (the sharding-plan dry run), so that
    ``float()`` reads them; a no-op otherwise."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    return unset_fake_temporarily()


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warm-up over ``warmup`` steps, then a cosine decay to 0 at
    ``total``; computed in float32 as the reference does."""
    def lr(step) -> float:
        with _on_host():
            step = torch.tensor(float(step), dtype=torch.float32)
            warm = base_lr * step / max(warmup, 1)
            frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                               0.0, 1.0)
            cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
            return float(torch.where(step < warmup, warm, cos))
    return lr


def _lr(lr: LR, step: int) -> float:
    return lr(step) if callable(lr) else lr


def _grads_f32(params) -> list:
    return [torch.zeros_like(p, dtype=torch.float32,
                             memory_format=torch.contiguous_format)
            if p.grad is None else p.grad.to(torch.float32)
            for p in params]


class AdamW(torch.optim.Optimizer):
    """AdamW with global-norm clipping and no decay on 1-D parameters."""

    def __init__(self, params: Iterable, lr: LR = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay,
                                      clip_norm=clip_norm))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            grads = _grads_f32(params)
            if group["clip_norm"]:
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(group["clip_norm"] / (gnorm + 1e-9),
                                    max=1.0)
                grads = [g * scale for g in grads]
            b1, b2 = group["b1"], group["b2"]
            for p, g in zip(params, grads):
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["m"] = torch.zeros_like(
                        p, dtype=torch.float32,
                        memory_format=torch.contiguous_format)
                    st["v"] = torch.zeros_like(st["m"])
                st["step"] += 1
                with _on_host():
                    t = torch.tensor(float(st["step"]), dtype=torch.float32)
                    mc = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
                    vc = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
                m = st["m"].mul_(b1).add_(g, alpha=1 - b1)
                v = st["v"].mul_(b2).add_(g * g, alpha=1 - b2)
                u = (m / mc) / (torch.sqrt(v / vc) + group["eps"])
                if group["weight_decay"] and p.dim() >= 2:
                    u = u + group["weight_decay"] * p.to(torch.float32)
                lr = _lr(group["lr"], st["step"])
                p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
        return loss


class Sgd(torch.optim.Optimizer):
    """Plain SGD, optionally with heavy-ball momentum
    (``mu = momentum * mu + g``), no clipping."""

    def __init__(self, params: Iterable, lr: LR = 1e-2,
                 momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p, g in zip(group["params"], _grads_f32(group["params"])):
                st = self.state[p]
                st["step"] = st.get("step", 0) + 1
                lr = _lr(group["lr"], st["step"])
                if group["momentum"]:
                    if "mu" not in st:
                        st["mu"] = torch.zeros_like(g)
                    g = st["mu"].mul_(group["momentum"]).add_(g)
                p.copy_((p.to(torch.float32) - lr * g).to(p.dtype))
        return loss
