"""The metric arithmetic on synthetic data: the 95th percentile over every
request, rates over the whole window, and the trace's reduction (union of
intervals over two overlapping streams, attribution by launch)."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import stats, trace


def test_p95_over_all_requests():
    rng = np.random.default_rng(0)
    lat = list(rng.lognormal(3.4, 0.2, 451))
    assert stats.percentile(lat, 95) == pytest.approx(float(np.percentile(lat, 95)))
    assert stats.percentile([7.0], 95) == 7.0
    # the tail is of all requests: one slow request among 20 moves it
    assert stats.percentile([10.0] * 19 + [100.0], 95) > 10.0


def test_rate_over_the_whole_window():
    # 3 requests of 8 scenes from t=0 to the last one's end at 2.5 s
    units = [(0.0, 1.0, 8), (1.0, 1.8, 8), (1.8, 2.5, 8)]
    assert stats.rate([n for *_, n in units], units[0][0], units[-1][1]) == pytest.approx(24 / 2.5)


def test_union_of_overlapping_streams():
    assert stats.union_length([(0, 4), (2, 6), (8, 9)]) == 7
    assert stats.merge([(5, 6), (0, 1), (1, 2)]) == [(0, 2), (5, 6)]


def _ns(ms):
    return int(ms * 1e6)


def test_trace_summary_two_streams_and_attribution():
    """Two units of 10 ms; unit 0 launches one kernel in its encode range and
    two that overlap on two streams; unit 1 one kernel.  A copy counts as
    busy but not as a kernel."""
    ranges = {trace.UNIT: [(_ns(0), _ns(10)), (_ns(10), _ns(20))],
              trace.ENCODE: [(_ns(0), _ns(2))],
              trace.DRAIN: [(_ns(20), _ns(22))]}
    launch_at = {1: _ns(1), 2: _ns(3), 3: _ns(4), 4: _ns(11), 5: _ns(12)}
    device = [(_ns(1), _ns(5), "encode_kernel", 1),       # launched in encode
              (_ns(5), _ns(9), "loop_a", 2),              # stream 1
              (_ns(6), _ns(8), "loop_b", 3),              # stream 2, inside loop_a
              (_ns(12), _ns(21), "loop_c", 4),
              (_ns(21), _ns(21.5), "Memcpy DtoH", 5)]
    host = [(_ns(0), _ns(22), "aten::whatever")]
    s = trace._summarize(ranges, launch_at, host, device)
    assert s.units == 2
    assert s.window_s == pytest.approx(0.022)
    assert s.busy_s == pytest.approx((8 + 9.5) / 1e3)  # 1-9 and 12-21.5 ms
    assert 0 <= 1 - s.busy_s / s.window_s <= 1
    assert s.launches == [3, 1]
    assert s.device_ms == pytest.approx([8.0, 9.0])
    assert s.outside_encode_ms == pytest.approx([4.0, 9.0])  # loop_a with loop_b inside
    assert s.encode_ms == pytest.approx([2.0, 0.0])
    assert s.device_ops[0] == ("loop_c", pytest.approx(0.009))
    assert s.idle_gaps[0][1] == pytest.approx(0.003)  # 9 ms to 12 ms
    assert s.idle_gaps[0][0].startswith("host: aten::whatever")
