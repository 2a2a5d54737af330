"""RL001 true positives: a collective with a backward inside the loss.

Each rank's gradients are summed by ``sum_grads_and_loss`` after the
backward, so a collective differentiated with the loss scales them by
the world size.
"""
import torch
import torch.distributed.nn.functional as dnf

from repro_torch.core import collectives as C
from repro_torch.core.collectives import ReduceScatter
from repro_torch.core.propagation import sum_grads_and_loss


def local_loss(h, labels):
    nll = torch.nn.functional.cross_entropy(h, labels, reduction="sum")
    return C.AllGather.apply(nll.reshape(1)).sum()     # BAD: via the call


def step(params, h, labels):
    loss = local_loss(h, labels)
    loss.backward()
    return sum_grads_and_loss(params, loss)


def step_slice(params, x):
    z = ReduceScatter.apply(x @ params[0])             # BAD: via the slice
    loss = z.square().sum()
    loss.backward()


def step_grad(params, x):
    out = (x @ params[0]).sum()
    return torch.autograd.grad(dnf.all_reduce(out), params)   # BAD: dist.nn
