"""RL008 clean: the kernel is picked by the tensor's device, and a
failure on the card is an error."""
from repro_torch.kernels import segment_sum as ss


def aggregate(msgs, order, row_ptr, n):
    fn = ss.pick(ss.segment_sum_cuda, ss.segment_sum_plain, msgs)
    try:
        return fn(msgs, order, row_ptr, n)
    except RuntimeError as e:
        raise RuntimeError(f"segment_sum failed on {msgs.device}") from e
