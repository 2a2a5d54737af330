"""The collectives of the distributed full-graph paths, over
``torch.distributed`` with the gloo backend.

They stand in for what ``shard_map`` gives the reference over mesh axis
``"g"``: one process a rank, every graph array cut along dim 0 into equal
per-rank slices (``ShardedGraph``), the parameters replicated.

* :class:`AllGather` — the tiled all-gather along dim 0, differentiable:
  its backward is the sum reduce-scatter of the cotangent, the transpose
  JAX takes for ``all_gather`` under ``check_rep=False``.
* :class:`ReduceScatter` — the sum reduce-scatter (push mode's
  ``psum_scatter``), whose backward is the all-gather.
* :func:`all_reduce_sum`, :func:`broadcast` — no autograd: the loss, the
  label count and the gradients.

Every sum is computed here, in rank order, after the pieces have been
exchanged (an all-gather, or an all-to-all for the reduce-scatter): no
float atomics and no order that depends on the backend, so a sum is the
same bits on every rank and from run to run.  CUDA tensors are staged
explicitly through pinned host buffers (gloo's own CUDA support differs
between collectives and PyTorch versions), and :data:`STATS` counts the
bytes each collective moves and the seconds it spends staging (device to
host and back) and waiting on gloo.

Several ranks may share one card (N processes on ``cuda:0``): NCCL refuses
that, gloo does not, so this is a model of the algorithm, not of NVLink.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

#: seconds any collective may wait for the other ranks before it raises
#: (a rank that died must not hang the others)
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class CommStats:
    """What the collectives of this process moved and spent since the
    last :meth:`reset`: ``calls`` and ``bytes_sent`` / ``bytes_received``
    (payload leaving and entering this rank, its own slice excluded) by
    collective, ``stage_s`` (device-host copies of CUDA tensors and the
    rank-order sums) and ``wait_s`` (inside gloo)."""
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes_sent: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes_received: Dict[str, int] = dataclasses.field(default_factory=dict)
    stage_s: float = 0.0
    wait_s: float = 0.0

    def reset(self) -> None:
        self.calls.clear()
        self.bytes_sent.clear()
        self.bytes_received.clear()
        self.stage_s = 0.0
        self.wait_s = 0.0

    def record(self, kind: str, sent: int, received: int) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes_sent[kind] = self.bytes_sent.get(kind, 0) + sent
        self.bytes_received[kind] = (self.bytes_received.get(kind, 0)
                                     + received)

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls),
                "bytes_sent": sum(self.bytes_sent.values()),
                "bytes_received": sum(self.bytes_received.values()),
                "stage_s": self.stage_s, "wait_s": self.wait_s}


STATS = CommStats()


def init_world(rank: int, world: int, device, store_path: str, *,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the gloo group of ``world`` ranks as ``rank``, through a
    ``FileStore`` at ``store_path`` (a file, not a TCP port, so that
    concurrent worlds on one machine never collide).  ``device`` is the
    rank's torch device; a CUDA device becomes the current one."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    STATS.reset()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank()


def world_size() -> int:
    return dist.get_world_size()


# ---------------------------------------------------------------------------
# staging: CUDA tensors cross through pinned host buffers
# ---------------------------------------------------------------------------

# pinned buffers by (role, shape, dtype): a step's collectives reuse them
_PINNED: Dict[Tuple, torch.Tensor] = {}


def _host(role: str, shape, dtype: torch.dtype, pinned: bool
          ) -> torch.Tensor:
    if not pinned:
        return torch.empty(shape, dtype=dtype)
    key = (role, tuple(shape), dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(shape, dtype=dtype,
                                         pin_memory=True)
    return buf


def release_buffers() -> None:
    """Drop the pinned staging buffers (a run at other shapes follows)."""
    _PINNED.clear()


def _to_host(t: torch.Tensor, role: str) -> torch.Tensor:
    """``t`` as a contiguous CPU tensor: itself on the CPU, else a copy
    into a pinned buffer, complete on return."""
    t = t.contiguous()
    if t.device.type == "cpu":
        return t
    t0 = time.perf_counter()
    buf = _host(role, t.shape, t.dtype, True)
    buf.copy_(t)                  # from the device: waits for the copy
    STATS.stage_s += time.perf_counter() - t0
    return buf


def _to_device(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return buf
    t0 = time.perf_counter()
    out = buf.to(device)          # from a pinned buffer: synchronous
    STATS.stage_s += time.perf_counter() - t0
    return out


def _wait(fn) -> None:
    t0 = time.perf_counter()
    fn()
    STATS.wait_s += time.perf_counter() - t0


def _sum_in_rank_order(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, left to right, on ``parts``'s
    device: the same bits on every rank."""
    t0 = time.perf_counter()
    out = parts[0].clone()
    for q in range(1, parts.shape[0]):
        out += parts[q]
    if out.device.type == "cuda":
        torch.cuda.current_stream(out.device).synchronize()
    STATS.stage_s += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def all_gather(t: torch.Tensor) -> torch.Tensor:
    """The tiled all-gather along dim 0: every rank's ``t`` (all of one
    shape), stacked in rank order, on ``t``'s device."""
    world = world_size()
    src = _to_host(t, "gather_in")
    out = _host("gather_out", (world * src.shape[0],) + tuple(src.shape[1:]),
                src.dtype, t.device.type == "cuda")
    _wait(lambda: dist.all_gather(list(out.chunk(world)), src))
    nbytes = src.numel() * src.element_size()
    STATS.record("all_gather", (world - 1) * nbytes, (world - 1) * nbytes)
    return _to_device(out, t.device)


def reduce_scatter(t: torch.Tensor) -> torch.Tensor:
    """The sum reduce-scatter along dim 0: ``t`` (world * n, ...) on every
    rank; rank r gets the sum over ranks, in rank order, of their slice
    ``r``.  The slices cross in one all-to-all; the sum is taken on
    ``t``'s device."""
    world = world_size()
    if t.shape[0] % world:
        raise ValueError(f"{t.shape[0]} rows do not split over {world} "
                         f"ranks")
    src = _to_host(t, "scatter_in")
    recv = _host("scatter_out", tuple(src.shape), src.dtype,
                 t.device.type == "cuda")
    _wait(lambda: dist.all_to_all_single(recv, src))
    nbytes = src.numel() * src.element_size() // world
    STATS.record("reduce_scatter", (world - 1) * nbytes, (world - 1) * nbytes)
    parts = _to_device(recv, t.device).reshape(
        (world, t.shape[0] // world) + tuple(t.shape[1:]))
    return _sum_in_rank_order(parts)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``t``: an all-gather, then the sum in rank
    order, so every rank holds the same bits."""
    world = world_size()
    gathered = all_gather(t.reshape((1,) + tuple(t.shape)))
    return _sum_in_rank_order(gathered.reshape((world,) + tuple(t.shape)))


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank (a new tensor on ``t``'s
    device)."""
    world = world_size()
    buf = (_to_host(t, "bcast") if t.device.type == "cuda"
           else t.contiguous().clone())
    _wait(lambda: dist.broadcast(buf, src))
    nbytes = buf.numel() * buf.element_size()
    STATS.record("broadcast", (world - 1) * nbytes if rank() == src else 0,
                 0 if rank() == src else nbytes)
    return _to_device(buf, t.device)


class AllGather(torch.autograd.Function):
    """:func:`all_gather` with its transpose: the cotangent of the
    gathered rows is reduce-scattered back to their owners (summed over
    the ranks that read them)."""

    @staticmethod
    def forward(ctx, t):
        return all_gather(t)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g)


class ReduceScatter(torch.autograd.Function):
    """:func:`reduce_scatter` with its transpose, the all-gather."""

    @staticmethod
    def forward(ctx, t):
        return reduce_scatter(t)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g)


def check_same(value: bytes, what: str) -> None:
    """Raise unless ``value`` (a digest) is the same on every rank."""
    mine = torch.frombuffer(bytearray(value.ljust(64, b"\0")[:64]),
                            dtype=torch.uint8)
    got = all_gather(mine[None])
    if not bool((got == got[0]).all()):
        raise RuntimeError(f"{what} differs between ranks")


class StepClock:
    """Per-step times of a distributed step: ``wall_s`` on the host clock
    (the step ends when its loss is read), ``event_ms`` between CUDA
    events around it on a card (None on the CPU), and what the
    collectives spent (``stage_s``, ``wait_s``, their sum ``comm_s``)
    and moved (``bytes_sent``, ``bytes_received``) inside it; one dict a
    step in ``rows``."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.rows: List[dict] = []

    @contextlib.contextmanager
    def step(self):
        cuda = self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        c0 = STATS.snapshot()
        t0 = time.perf_counter()
        yield
        if cuda:
            ev[1].record()
            ev[1].synchronize()
        wall = time.perf_counter() - t0
        c1 = STATS.snapshot()
        stage = c1["stage_s"] - c0["stage_s"]
        wait = c1["wait_s"] - c0["wait_s"]
        self.rows.append({
            "wall_s": wall,
            "event_ms": ev[0].elapsed_time(ev[1]) if cuda else None,
            "stage_s": stage, "wait_s": wait, "comm_s": stage + wait,
            "bytes_sent": c1["bytes_sent"] - c0["bytes_sent"],
            "bytes_received": c1["bytes_received"] - c0["bytes_received"]})


def rank_device(rank_: int, device: str) -> torch.device:
    """The device rank ``rank_`` runs on: ``cpu``, or for ``cuda`` the
    card ``rank_ % device_count()`` (several ranks share a card when
    there are fewer cards than ranks); an explicit ``cuda:i`` is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank_ % max(torch.cuda.device_count(),
                                                1))
    return dev
