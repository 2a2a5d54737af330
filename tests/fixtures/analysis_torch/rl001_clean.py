"""RL001 clean: collectives outside the differentiated loss.

The local loss is differentiated alone; the loss and the gradients are
summed after the backward, a detached gather carries no graph, and the
host-side ``all_reduce_sum`` has no backward.
"""
import torch

from repro_torch.core import collectives as C
from repro_torch.core.propagation import sum_grads_and_loss


def local_loss(h, labels, cnt):
    return torch.nn.functional.cross_entropy(h, labels,
                                             reduction="sum") / cnt


def step(params, h, labels, mask):
    cnt = C.all_reduce_sum(mask.sum())         # no backward: fine
    seen = C.AllGather.apply(h).detach()       # detached: fine
    loss = local_loss(h, labels, cnt) + 0.0 * seen.sum().item()
    loss.backward()
    total = sum_grads_and_loss(params, loss)
    later = C.AllGather.apply(h)               # after the backward: fine
    return total, later
