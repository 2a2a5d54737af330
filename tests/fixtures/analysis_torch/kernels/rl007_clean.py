"""RL007 clean: every public wrapper refuses an input that requires grad
before anything launches; private helpers are reached only through
them."""
import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_sum import _refuse_grad


def _launch(x, out) -> None:
    build.library("fixture").scale(x.data_ptr(), out.data_ptr())


def _prepare(x):
    _refuse_grad("prepared_cuda", None, x)
    return torch.empty_like(x)


def scale_cuda(x: torch.Tensor) -> torch.Tensor:
    _refuse_grad("scale_cuda", "kernels.fixture.Scale", x)
    out = torch.empty_like(x)
    build.check(build.library("fixture").scale(x.data_ptr(),
                                               out.data_ptr()), "scale")
    return out


def prepared_cuda(x: torch.Tensor) -> torch.Tensor:      # refuses in _prepare
    out = _prepare(x)
    _launch(x, out)
    return out


def scale_card(x: torch.Tensor) -> torch.Tensor:         # through scale_cuda
    return scale_cuda(x)


def plan(x: torch.Tensor) -> dict:                       # launches nothing
    return {"numel": x.numel()}
