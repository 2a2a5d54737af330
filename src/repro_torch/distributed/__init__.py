"""Partition-aware distributed training (survey §3.2).

The port holds the **asynchronous full-graph** family (PipeGCN/DistGNN
recipe): per-layer ghost activations exchanged with bounded staleness,
refresh planning overlapped with device compute
(:mod:`~repro_torch.distributed.async_train`), and the
:class:`~repro_torch.distributed.pipeline.HostPrefetcher` it plans on.
The reference's mini-batch family (``sampler``, ``collate``, the
partition-parallel step) is not ported yet (ROADMAP.md queue 1, item 9
(iii)).
"""
from repro_torch.distributed.async_train import (AsyncFullGraphTrainer,
                                                 exchange_for_shards,
                                                 make_async_fullgraph_step)
from repro_torch.distributed.pipeline import HostPrefetcher

__all__ = [
    "AsyncFullGraphTrainer",
    "HostPrefetcher",
    "exchange_for_shards",
    "make_async_fullgraph_step",
]
