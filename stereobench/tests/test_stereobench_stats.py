"""The spread over runs and the union of device intervals."""

import statistics

import pytest

from stereobench.stats import spread, union_seconds


def test_spread_uses_python_quartiles():
    v = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert spread(v) == pytest.approx((q3 - q1) / q2)


def test_union_of_intervals():
    assert union_seconds([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert union_seconds([]) == 0.0

