"""The benchmark's arithmetic: rates over the window and the union idle
share."""
import pytest

import portbench_small  # noqa: F401
from portbench import stats


def test_rate_counts_steps_completed_inside_the_window_over_its_length():
    # steps of 10 units end at 1, 2, 3 and (past the close at 3.5) 4
    assert stats.rate([10, 10, 10, 10], [1, 2, 3, 4], 0.0, 3.5) \
        == pytest.approx(30 / 3.5)
    assert stats.rate([5, 15], [1.0, 2.0], 0.0, 2.0) == 10.0
    # a stall before the close lowers the rate
    assert stats.rate([10, 10], [1.0, 2.0], 0.0, 4.0) == 5.0
    assert stats.rate([1], [5.0], 0.0, 3.0) == 0.0


def test_union_and_idle_gaps_on_synthetic_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert stats.union_seconds(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.union_seconds(iv, 1.0, 3.5) == pytest.approx(1.5)
    gaps = stats.idle_gaps(iv, 0.0, 10.0)
    assert gaps == [(4.0, 9.0), (2.0, 3.0)]
    assert stats.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    busy = stats.union_seconds(iv, 0.0, 10.0)
    assert busy + sum(b - a for a, b in gaps) == pytest.approx(10.0)
