"""Production mesh builders (the reference's ``launch/mesh.py``).

These are FUNCTIONS, not module constants, so importing this module
starts no process group.  :func:`make_production_mesh` builds its
``DeviceMesh`` over a fake process group of 256 or 512 ranks
(:func:`start_fake_world`): every collective is a no-op and nothing
reaches a device, which is what the sharding-plan dry run
(``launch/dryrun.py``) needs.  :func:`make_host_mesh` is the degenerate
1x1 mesh on the real local device.
"""
from __future__ import annotations

import numpy as np

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def start_fake_world(world_size: int) -> bool:
    """Starts a fake process group of ``world_size`` ranks (this process
    rank 0) unless a group exists; returns whether it started one (the
    caller then destroys it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; the mesh needs {world_size}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    return True


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 chips) or 2x16x16 two-pod (512 chips) mesh on
    the fake process group (started here when none exists)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    start_fake_world(int(np.prod(shape)))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda"):
    """Degenerate 1x1 mesh on the real local device, over a one-rank
    world (started by the caller: ``torch.distributed`` with any
    backend)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
