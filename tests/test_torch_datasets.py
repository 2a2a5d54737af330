"""The port's synthetic dataset registry (``repro_torch.graph.datasets``)
against the reference's: every entry bitwise (graph, features, labels,
masks), at the default seed and another, and the split helper."""
import numpy as np
import pytest

from repro.graph import datasets as RD
from repro_torch.graph import datasets as D


def _assert_same(got, want):
    assert (got.name, got.task) == (want.name, want.task)
    g, r = got.graph, want.graph
    for field in ("row_ptr", "col_idx", "features", "labels"):
        a, b = getattr(g, field), getattr(r, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert g.num_classes == r.num_classes
    for mask in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(got, mask),
                                      getattr(want, mask), err_msg=mask)


def test_registry_names_equal_reference():
    assert list(D.DATASETS) == list(RD.DATASETS)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", list(RD.DATASETS))
def test_entry_equals_reference_bitwise(name, seed):
    got, want = D.load(name, seed=seed), RD.load(name, seed=seed)
    _assert_same(got, want)
    # the masks split every node once
    total = (got.train_mask.astype(int) + got.val_mask + got.test_mask)
    assert (total == 1).all()


@pytest.mark.parametrize("name,scale", [("reddit-like", 0.005),
                                        ("livejournal-like", 0.0005)])
def test_scaled_entry_equals_reference(name, scale):
    _assert_same(D.load(name, scale=scale), RD.load(name, scale=scale))


def test_unknown_name_raises_key_error():
    with pytest.raises(KeyError):
        D.load("ogbn-papers100m")


def test_splits_equal_reference():
    got = D._splits(101, np.random.default_rng(5), train=0.5, val=0.3)
    want = RD._splits(101, np.random.default_rng(5), train=0.5, val=0.3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
