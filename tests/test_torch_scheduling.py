"""The port's scheduling trio (``core/scheduling.py``) against the
reference's: FlexGraph's LPT assignment and cost model give the
reference's numbers on seeded inputs, and the work-stealing pool
completes every task and steals under imbalance (reference
``tests/test_substrate.py``)."""
import time

import numpy as np
import pytest

from repro.core import scheduling as ref
from repro_torch.core import scheduling as SC


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("workers", [1, 3, 8])
def test_lpt_assignment_matches_the_reference(seed, workers):
    rng = np.random.default_rng(seed)
    costs = rng.integers(1, 50, size=int(rng.integers(1, 40))).astype(
        np.float64)
    got = SC.cost_balanced_assignment(costs, workers)
    want = ref.cost_balanced_assignment(costs, workers)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    loads = np.bincount(got, weights=costs, minlength=workers)
    # LPT's bound: within 4/3 of the best plan, which is at least both
    assert loads.max() <= 4 / 3 * max(costs.sum() / workers, costs.max())


@pytest.mark.parametrize("seed", range(3))
def test_cost_model_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    nv = rng.integers(1, 10**6, 8)
    ne = rng.integers(1, 10**7, 8)
    got = SC.predict_partition_cost(nv, ne, 602, 256)
    want = ref.predict_partition_cost(nv, ne, 602, 256)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


def test_lpt_balance():
    costs = np.asarray([10, 9, 8, 1, 1, 1, 1, 1], np.float64)
    loads = np.bincount(SC.cost_balanced_assignment(costs, 4),
                        weights=costs, minlength=4)
    assert loads.max() <= 12            # the reference's bound


def test_work_stealing_completes_and_steals():
    tasks = [[lambda: time.sleep(0.002) or 1] * 12] + [[] for _ in range(3)]
    out = SC.WorkStealingPool(tasks).run()
    assert out["done"] == 12 and sorted(out["results"]) == [1] * 12
    assert out["stolen"] > 0           # idle workers stole from the loaded one


def test_work_stealing_runs_every_task_once():
    """More workers than cores, uneven queues: every task's result
    arrives exactly once."""
    tasks = [[(lambda i=i: i) for i in range(w * 50, w * 50 + 5 * w)]
             for w in range(12)]
    out = SC.WorkStealingPool(tasks).run()
    want = sorted(i for q in tasks for i in (t() for t in q))
    assert sorted(out["results"]) == want and out["done"] == len(want)
