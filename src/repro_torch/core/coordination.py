"""Parameter coordination (survey §3.2.9 / §2.3.3).

* ``decentralized`` — all-reduce (a mean) of gradients, every replica
  applies the update (MALT/CROSSBOW/DistGNN lineage).
* ``parameter_server`` — emulation of the centralized scheme (DistBelief
  / AGL): gradients are *gathered* to the root, the root applies the
  update, parameters are *broadcast* back (the survey's "single point of
  failure / bottleneck" claim, §2.3.3).

Both run on every rank of a :mod:`repro_torch.core.collectives` world,
with ``optimizer`` a torch optimizer built on the replicated ``params``
and ``grads`` this rank's gradients, one tensor a parameter.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import collectives as C


def _flat(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def _step(optimizer, params, grads) -> None:
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.grad = g.to(p.dtype)
    optimizer.step()


def allreduce_update(optimizer, params, grads) -> None:
    """Decentralized: the mean of the gradients over the ranks (summed in
    rank order, then divided), and every replica updates identically."""
    params = list(params)
    mean = C.all_reduce_sum(_flat(grads)) / C.world_size()
    _step(optimizer, params, _unflat(mean, params))


def parameter_server_update(optimizer, params, grads, *, root: int = 0
                            ) -> None:
    """Centralized PS emulation: every rank's gradients are gathered (the
    gather-to-root traffic; the other ranks' copies are an artifact of
    the emulation, as in the reference), the root's update is computed,
    and the root's parameters and floating optimizer state are broadcast
    to every rank."""
    params = list(params)
    gathered = C.all_gather(_flat(grads)[None])       # (world, n)
    _step(optimizer, params, _unflat(torch.mean(gathered, dim=0), params))
    with torch.no_grad():
        for p, v in zip(params, _unflat(C.broadcast(_flat(params), root),
                                        params)):
            p.copy_(v)
        for p in params:
            for k, v in optimizer.state[p].items():
                if torch.is_tensor(v) and v.is_floating_point():
                    v.copy_(C.broadcast(v, root))


COORDINATORS = {
    "decentralized": allreduce_update,
    "parameter_server": parameter_server_update,
}
