"""Online GNN inference serving (survey §3.2.2 / §3.2.4 applied at
inference time).

* :mod:`repro_torch.serving.request`  — request objects, FIFO queue,
  synthetic arrival processes.
* :mod:`repro_torch.serving.batcher`  — dynamic micro-batcher that pads
  every batch to one of a small set of declared bucket sizes.
* :mod:`repro_torch.serving.sampler`  — fixed-shape inference-time
  neighbor sampling built on
  :func:`repro_torch.core.sampling.sample_block_padded`.
* :mod:`repro_torch.serving.cache`    — layered historical-embedding cache
  with staleness bounds, built on
  :class:`repro_torch.core.caching.FeatureStore`.
* :mod:`repro_torch.serving.server`   — the serve loop: admit → batch →
  sample → fetch/cache → forward on the device → account latency.
* :mod:`repro_torch.serving.replica`  — one replica: private queue +
  batcher + compute path, scheduled by the router.
* :mod:`repro_torch.serving.router`   — the elastic replicated tier:
  dispatch policies, load-based autoscaling, rolling weight hot-swap
  under the shared version clock, crash-safe stop/resume.
"""
from repro_torch.serving.batcher import BucketedBatcher, MicroBatch
from repro_torch.serving.cache import EmbeddingCache
from repro_torch.serving.replica import ServingReplica
from repro_torch.serving.request import (InferenceRequest, RequestQueue,
                                         poisson_workload)
from repro_torch.serving.router import (AutoscalePolicy, AutoScaler,
                                        ReplicaRouter, RouterStats,
                                        restore_params)
from repro_torch.serving.sampler import ServingSampler
from repro_torch.serving.server import GNNInferenceServer, ServeStats

__all__ = [
    "BucketedBatcher", "MicroBatch", "EmbeddingCache", "InferenceRequest",
    "RequestQueue", "poisson_workload", "ServingSampler",
    "GNNInferenceServer", "ServeStats", "ServingReplica", "AutoscalePolicy",
    "AutoScaler", "ReplicaRouter", "RouterStats", "restore_params",
]
