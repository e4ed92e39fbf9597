"""The metric arithmetic on synthetic inputs: qps, the 95th percentile
over all requests, the spread, the roofline byte formulas and shares,
busy time, idle share and idle gaps from a trace."""
import re
import statistics
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, roofline, stats
from portbench import trace as tr


def _ctx(**kw):
    return harness.Readings(setup_s=kw.pop("setup_s", 1.0), **kw)


def test_qps_is_all_queries_over_the_window():
    ctx = _ctx(window_s=2.5, latencies_s=[0.1] * 10, queries=["a"] * 10)
    assert harness.metric("qps").read(ctx) == 4.0


def test_p95_is_over_all_requests():
    # two kinds of query, a fast half and a slow half: the 95th
    # percentile of all 200 latencies sits in the slow ones, far above
    # the median of per-chunk medians
    lat = [0.001] * 100 + [0.010 + i * 1e-5 for i in range(100)]
    ctx = _ctx(window_s=1.0, latencies_s=lat, queries=["a"] * 200)
    p95 = harness.metric("p95_ms").read(ctx)
    pos = 199 * 0.95
    v = sorted(lat)
    want = (v[int(pos)] + (v[int(pos) + 1] - v[int(pos)]) *
            (pos - int(pos))) * 1e3
    assert p95 == pytest.approx(want, rel=1e-12)
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile([1, 2], 95) == pytest.approx(1.95)
    assert stats.percentile([5], 95) == 5


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10, 11, 12, 13, 14, 15]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == (q3 - q1) / 12.5


def test_setup_frontend_and_counters():
    ctx = _ctx(setup_s=7.5, window_s=1.0, queries=["a"] * 4,
               launches={"radix_sort": 6},
               spans={"select: eval spec": [1.0, 2.0, 3.0]})
    assert harness.metric("setup_s").read(ctx) == 7.5
    assert harness.metric("frontend_ms").read(ctx) == 2.0
    assert harness.metric("sort_calls_per_query").read(ctx) == 1.5
    ctx.spans, ctx.launches = {}, {"radix_sort": 0}
    assert harness.metric("frontend_ms").read(ctx) is None
    assert harness.metric("sort_calls_per_query").read(ctx) is None


def test_roofline_byte_formulas():
    i32 = torch.zeros(1000, dtype=torch.int32)
    sort = harness.metric("radix_sort_roofline")
    # 3 words in, 3 out: 6 * 1000 * 4; with the permutation one more out
    assert sort.call_bytes([i32] * 3, 1) == 24_000
    assert sort.call_bytes([i32] * 3, 2, perm=True) == 28_000
    scan = harness.metric("seg_scan_roofline")
    vals = torch.zeros((1000, 3), dtype=torch.float64)
    assert scan.call_bytes(i32, vals, "sum") == 1000 * (4 + 2 * 8 * 3)


def _event(name, start, dur, device):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: getattr(torch.autograd.DeviceType, device),
        is_user_annotation=lambda: False)


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_trace_busy_idle_gaps_and_roofline_share():
    ev = [_event("pass_kernel<16>(Slots)", 1000, 3000, "CUDA"),
          _event("seg_scan::block_pass<int>", 3500, 1000, "CUDA"),  # overlaps
          _event("Memset (Device)", 6000, 500, "CUDA"),
          _event("dense_agg::dense_pass", 9000, 1000, "CUDA"),
          _event("aten::sort", 4000, 2500, "CPU"),
          _event("aten::item", 6000, 2000, "CPU"),
          _event("outside", 20000, 100, "CUDA")]
    spans = [(0, 8000, "q1"), (8500, 10000, "q2")]
    t = tr.summarize(_prof(ev), 0, 10000, spans)
    assert t.window_s == 1e-5
    # busy: [1000, 4500] + [6000, 6500] + [9000, 10000]
    assert t.busy_s == pytest.approx((3500 + 500 + 1000) / 1e9)
    assert t.kernels == 3
    assert t.device_ops[0] == ["pass_kernel<16>(Slots)", 3e-6]
    # gaps: [0, 1000], [4500, 6000], [6500, 9000], longest first; the
    # host op that covers half of each or more, and the query running
    assert t.idle_gaps == [["q1: aten::item", 2.5e-6],
                           ["q1: aten::sort", 1.5e-6],
                           ["q1: host code outside the traced calls",
                            1e-6]]
    idle = harness.metric("device_idle_share")
    ctx = _ctx(window_s=1.0, queries=["q"] * 2, trace=t)
    assert idle.read(ctx) == pytest.approx(100 * (1 - 5000 / 10000))
    assert harness.metric("device_busy_ms").read(ctx) == \
        pytest.approx(5000 / 1e6 / 2)
    assert harness.metric("kernels_per_query").read(ctx) == 1.5
    ctx.calls = {"radix_sort_roofline": [3350, 3350]}
    share = harness.metric("radix_sort_roofline").read(ctx)
    assert share == pytest.approx(100 * 6700 / roofline.HBM_BYTES_PER_S /
                                  3e-6)
    assert harness.metric("seg_scan_roofline").read(ctx) is None
    assert roofline.share(ctx, "x", re.compile("nothing")) is None
