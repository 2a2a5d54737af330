"""The port's int8 wire codec on rows whose range is subnormal: the stored
scale stays positive and every decoded element lies within scale / 2 of
the float64 truth, as ``Int8Codec`` states.  Rows of a normal range keep
the reference's encoding bit for bit."""
import numpy as np
import pytest

from repro.core import comm as ref_comm
from repro_torch.core.comm import CODECS

SUBNORMAL_ROWS = [
    [0.0, 1e-44],                # range / 255 underflows to 0
    [-1e-40, 1e-40],             # range / 255 rounds in the subnormals
    [1e-45, 3e-45, 0.0],
    [1.2e-38, 1.2000001e-38],    # two normal values one step apart
    [-3e-42, 5e-43, 7e-42, 0.0],
]


@pytest.mark.parametrize("row", SUBNORMAL_ROWS)
def test_int8_error_at_most_half_scale_on_subnormal_ranges(row):
    x = np.asarray([row], np.float32)
    codec = CODECS["int8"]
    p = codec.encode(x)
    q, _, scale = p.data
    s = float(scale[0, 0])
    assert s > 0 and q.max() <= 255
    err = np.abs(codec.decode(p).astype(np.float64) - x.astype(np.float64))
    assert (err <= 0.5 * s).all()


def test_int8_normal_rows_encode_as_the_reference_does():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 37)) * np.logspace(-30, 30, 64)[:, None]
         ).astype(np.float32)
    x[3] = 2.5                                     # a constant row
    got = CODECS["int8"].encode(x).data
    want = ref_comm.CODECS["int8"].encode(x).data
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
