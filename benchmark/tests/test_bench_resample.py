"""`resample_ms_per_call.eval` on synthetic profiler events: the device ms
a call of the upsample and max-pool kernels, 0.0 without them, nothing
without device work."""

import pytest

from benchmark.metrics import reader
from benchmark.yardstick import trace as T

UPSAMPLE = ("void at::native::(anonymous namespace)::"
            "upsample_nearest2d_nhwc_out_frame<c10::BFloat16>(...)")
MAX_POOL = ("void at::native::(anonymous namespace)::"
            "max_pool_forward_nhwc<c10::BFloat16, float>(...)")


def _trace(device, units=2):
    spans = [(T.WINDOW, 0.0, 1000.0)]
    return T.Trace(list(device), [], spans, [], units)


def test_sums_upsample_and_max_pool_per_call():
    dev = [(UPSAMPLE, 0.0, 100.0), (MAX_POOL, 100.0, 150.0),
           (MAX_POOL, 900.0, 1100.0),                  # clipped at the end
           ("sm90_xmma_fprop", 150.0, 400.0),
           ("dvg_elementwise_epilogue_pool", 400.0, 500.0)]
    read = reader("resample_ms_per_call.eval")
    assert read(_trace(dev), {}) == pytest.approx((100 + 50 + 100) / 1e3 / 2)


def test_zero_without_resampling_kernels_and_none_without_device_work():
    read = reader("resample_ms_per_call.eval")
    dev = [("sm90_xmma_fprop", 0.0, 10.0), ("dgrad_kernel", 10.0, 20.0)]
    assert read(_trace(dev), {}) == 0.0
    assert read(_trace([]), {}) is None
