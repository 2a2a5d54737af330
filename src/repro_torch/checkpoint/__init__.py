"""Crash-safe checkpoints of nested dicts of tensors (see :mod:`.io`)."""
from repro_torch.checkpoint.io import (latest_step, load_checkpoint,  # noqa: F401
                                       save_checkpoint)
