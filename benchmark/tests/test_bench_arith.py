"""The metric arithmetic on synthetic timings and synthetic profiler
events: rates, the idle share as an interval union, launches,
MFU, the K1 roofline, and the breakdown."""

import math

import pytest

from benchmark.metrics import reader
from benchmark.yardstick import peaks
from benchmark.yardstick import trace as T


def _trace(device, runtime=(), units=2, window=(0.0, 1000.0), host=()):
    spans = [(T.WINDOW, *window), ("bench.call", window[0], 600.0),
             ("bench.sync", 600.0, window[1])]
    return T.Trace(list(device), list(runtime), spans, list(host), units)


def test_union_merges_overlaps_and_drops_empty():
    assert T.union([(5, 7), (0, 2), (1, 3), (7, 8), (9, 9)]) == [(0, 3),
                                                                 (5, 8)]


def test_idle_share_is_one_minus_the_union_over_the_whole_window():
    # two overlapping kernels 100-300 and 200-400, one 700-800, and one
    # that runs past the window's end; host gaps at both ends count
    dev = [("k1", 100, 300), ("k2", 200, 400), ("k3", 700, 800),
           ("k4", 950, 1200)]
    tr = _trace(dev)
    assert T.busy_s(tr) == pytest.approx((300 + 100 + 50) / 1e6)
    assert T.idle_pct(tr) == pytest.approx(100 * (1 - 450 / 1000))
    assert reader("device_idle_pct.eval")(tr, {}) == pytest.approx(55.0)
    # the first-to-last-kernel span with summed durations would read
    # busy 100%: the gaps at the ends and the overlap are what it misses
    gaps = T.idle_gaps(tr)
    assert gaps[0] == (0.0, 100) and gaps[-1] == (800, 950)


def test_idle_reader_finds_nothing_without_device_events():
    assert reader("device_idle_pct.train")(_trace([]), {}) is None


def test_launches_count_runtime_launch_calls_per_unit():
    rt = [("cudaLaunchKernel", 10, 11)] * 6 + [
        ("cudaGraphLaunch", 20, 21), ("cudaMemcpyAsync", 30, 31),
        ("cudaStreamSynchronize", 40, 900), ("cudaLaunchKernel", 1500, 1501)]
    tr = _trace([("k", 0, 10)], rt, units=4)
    assert T.launches(tr) == 8
    assert reader("launches_per_step.train")(tr, {}) == 2.0


def test_rate_over_completed_units_and_the_whole_window():
    from benchmark.drivers.eval import Driver
    d = Driver.__new__(Driver)
    d.s_n, d.n_free, d.b = 100, 100, 50
    d.times = [1.4, 1.5, 1.45]
    out = d.measure(10.0, 14.5)
    assert out["eval_frames_per_s"] == pytest.approx(3 * 500_000 / 4.5)


def test_mfu_over_the_traced_time_per_unit():
    tr = _trace([("k", 0, 500)], units=2, window=(0.0, 2e6))  # 2 s
    ctx = {"flops_per_unit": 0.5 * peaks.BF16_FLOP_PER_S}
    # one unit of 0.5 s of peak work per 1 s of window: 50%
    assert reader("eval_mfu_pct")(tr, ctx) == pytest.approx(50.0)
    assert reader("train_mfu_pct")(tr, {"flops_per_unit": None}) is None


def test_k1_roofline_against_the_frozen_cost_model():
    shape = (100, 50, 64, 64, 1, 2)
    nbytes, flops = peaks.k1_cost(*shape)
    bound_ms, by = peaks.bound(nbytes, flops)
    assert by == "operations"
    assert bound_ms == pytest.approx(flops / peaks.F32_FLOP_PER_S * 1e3)
    launch_us = 4 * bound_ms * 1e3
    k1 = [(f"void ssim_kernel<{i}>", i * 1e4, i * 1e4 + launch_us)
          for i in range(5)]
    tr = _trace(k1 + [("elementwise_kernel", 0, 10)], window=(0, 1e6))
    got = reader("k1_roofline")(tr, {"k1_shape": shape})
    assert got == pytest.approx(25.0)
    assert reader("k1_roofline")(_trace([("gemm", 0, 1)]), {
        "k1_shape": shape}) is None


def test_elementwise_ms_per_call_by_the_frozen_groups():
    dev = [("vectorized_elementwise_kernel<add>", 0, 2000),
           ("elementwise_kernel<leaky>", 3000, 4000),
           ("sm90_xmma_fprop", 4000, 9000),
           ("ssim_kernel", 9000, 9500)]
    tr = _trace(dev, units=2, window=(0, 1e4))
    assert reader("elementwise_ms_per_call.eval")(tr, {}) == \
        pytest.approx(1.5)
    groups = T.device_ms_by_group(tr, T.KERNEL_GROUPS)
    assert groups["K1 ssim_kernel (cyclic mode)"] == pytest.approx(0.5)
    assert groups["conv (fprop)"] == pytest.approx(5.0)


def test_breakdown_names_the_longest_gaps_by_what_the_host_did():
    dev = [(f"k{i}", 100 * i, 100 * i + 60) for i in range(10)]
    host = [("aten::copy_", 990, 1000), ("aten::conv2d", 0, 640)]
    rt = [("cudaStreamSynchronize", 600, 1000)]
    tr = _trace(dev, rt, host=host, window=(0, 1000))
    out = T.breakdown(tr, T.KERNEL_GROUPS)
    assert len(out["device_ops"]) <= T.BREAKDOWN_ENTRIES
    assert sum(s for _, s in out["device_ops"]) == pytest.approx(600e-6)
    assert len(out["idle_gaps"]) == 10
    assert all(math.isclose(s, 40e-6) for _, s in out["idle_gaps"])
    labels = {n for n, _ in out["idle_gaps"]}
    assert "bench.call / aten::conv2d" in labels
    assert "bench.sync / cudaStreamSynchronize" in labels
