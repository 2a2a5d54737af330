"""RL008 true positives: fallbacks that hide the device or the kernel."""
import torch

from repro_torch.kernels import build
from repro_torch.kernels import segment_sum as ss


def pick(cuda_fn, plain_fn, t):
    if not torch.cuda.is_available():                   # BAD: a probe
        return plain_fn
    return cuda_fn


def aggregate(msgs, order, row_ptr, n):
    try:
        return ss.segment_sum_cuda(msgs, order, row_ptr, n)
    except RuntimeError:
        return ss.segment_sum_plain(msgs, order, row_ptr, n)   # BAD: plain


def warm(x):
    try:
        build.build()
    except RuntimeError:
        return x.to("cpu")                              # BAD: to the CPU
    return x
