"""The window arithmetic: rates, the tail and the spread, and the device's
busy time as a union of intervals."""

import pytest

from portbench import stats, trace


def test_rate_counts_all_work_over_all_time():
    # 3 jobs of 100, 200, 700 gestures ending at 0.5, 1.0, 4.0 s after a
    # window start at 0: 1000 gestures over 4 s, not a mean of job rates.
    assert stats.rate(1000, 4.0) == 250.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_percentile_is_nearest_rank():
    values = list(range(1, 201))           # 1 .. 200 ms
    assert stats.percentile(values, 95) == 190
    assert stats.beyond(values, 95) == 10
    assert stats.percentile([5.0], 95) == 5.0
    # A stall moves the tail: one job of 10 s among 99 of 10 ms.
    assert stats.percentile([10.0] * 99 + [10_000.0], 95) == 10.0
    assert stats.percentile([10.0] * 90 + [10_000.0] * 10, 95) == 10_000.0


def test_spread_by_quartiles():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_union_and_idle_share():
    busy = trace.union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7)])
    assert busy == [(0.0, 2.0), (3.0, 4.0)]
    assert trace.gaps(busy, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    device = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("Memcpy HtoD", 3.0, 4.0),
              ("k1", 3.5, 3.7), ("late", 9.0, 9.5)]
    host = [("outer", 0.0, 5.0), ("inner", 2.1, 2.9)]
    r = trace.reduce_events(device, host, 0.0, 5.0)
    assert r["busy_s"] == pytest.approx(3.0)          # a sum would say 3.7
    assert 1 - r["busy_s"] / r["window_s"] == pytest.approx(0.4)
    assert r["kernels"] == 3 and r["copy_s"] == pytest.approx(1.0)
    assert r["ops"]["k1"] == [2, pytest.approx(1.2)] and "late" not in r["ops"]
    assert r["breakdown"]["idle_gaps"][0][0] == "inner"
    assert r["breakdown"]["idle_gaps"][1] == ["outer", pytest.approx(1.0)]
    assert trace.device_seconds(r["ops"], "k1", "k2") == (3, pytest.approx(2.7))
