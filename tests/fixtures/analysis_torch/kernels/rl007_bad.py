"""RL007 true positives: raw kernel wrappers that can launch on an input
that requires grad and return an output with no autograd graph."""
import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_sum import _refuse_grad


def scale_cuda(x: torch.Tensor) -> torch.Tensor:         # BAD: no refusal
    out = torch.empty_like(x)
    build.check(build.library("fixture").scale(x.data_ptr(),
                                               out.data_ptr()), "scale")
    return out


def late_cuda(x: torch.Tensor) -> torch.Tensor:          # BAD: too late
    out = torch.empty_like(x)
    build.library("fixture").scale(x.data_ptr(), out.data_ptr())
    _refuse_grad("late_cuda", "Late", x)
    return out


def maybe_cuda(x: torch.Tensor, strict: bool) -> torch.Tensor:   # BAD
    if strict:
        _refuse_grad("maybe_cuda", "Maybe", x)          # conditional
    out = torch.empty_like(x)
    _launch(x, out)
    return out


def _launch(x, out) -> None:
    build.library("fixture").scale(x.data_ptr(), out.data_ptr())


def via_helper_cuda(x: torch.Tensor) -> torch.Tensor:    # BAD: via helper
    out = torch.empty_like(x)
    _launch(x, out)
    return out
