"""Partition-aware distributed training (survey §3.2).

Two families, one process a rank over
:mod:`repro_torch.core.collectives`:

* **partition-parallel mini-batch** (DistDGL/PaGraph recipe): global
  seed batches split by partition ownership, each partition's padded
  neighbor sample fetched through a halo-cached feature store
  (:mod:`~repro_torch.distributed.sampler`), double-buffered on the host
  and trained by one rank's step that all-reduces the gradients
  (:mod:`~repro_torch.distributed.pipeline`);
* **asynchronous full-graph** (PipeGCN/DistGNN recipe): per-layer ghost
  activations exchanged with bounded staleness, refresh planning
  overlapped with device compute
  (:mod:`~repro_torch.distributed.async_train`).
"""
from repro_torch.distributed.async_train import (AsyncFullGraphTrainer,
                                                 exchange_for_shards,
                                                 make_async_fullgraph_step)
from repro_torch.distributed.pipeline import (HostPrefetcher, collate,
                                              make_distributed_minibatch_step)
from repro_torch.distributed.sampler import (DistributedMinibatchSampler,
                                             PartitionBatch,
                                             PartitionFeatureStore,
                                             device_blocks)

__all__ = [
    "AsyncFullGraphTrainer",
    "DistributedMinibatchSampler",
    "HostPrefetcher",
    "PartitionBatch",
    "PartitionFeatureStore",
    "collate",
    "device_blocks",
    "exchange_for_shards",
    "make_async_fullgraph_step",
    "make_distributed_minibatch_step",
]
