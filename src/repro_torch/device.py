"""Device resolution for the port.

Every entry point takes an explicit device, ``"cuda"`` by default.  A
CUDA request on a machine without a card raises: nothing quietly runs on
the CPU.  The CPU is used only when the caller asks for it, as the tests
do.

:func:`resolve` also turns TF32 off for float32 matrix products and
cuDNN convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False, for the process), so
float32 on the card keeps float32 precision and agrees with the CPU and
the reference.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises ``RuntimeError`` when a
    CUDA device is asked for and CUDA is not available.  Turns TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is "
                           f"not available on this machine")
    return dev
