"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), and the roofline arithmetic.

`k1_cost` and `bound` are frozen copies of `chip_smoke.py::k1_cost` and
`chip_smoke.py::bound`."""

from __future__ import annotations

from typing import Tuple

BF16_FLOP_PER_S = 989e12       # tensor cores, bf16/fp16 dense
F32_FLOP_PER_S = 67e12         # CUDA cores, float32
HBM_BYTES_PER_S = 3.35e12


def k1_cost(s_n: int, b: int, h: int, w: int, c: int, pred_bytes: int,
            win: int = 7) -> Tuple[int, int]:
    """(bytes, f32 operations) K1 must at least move and do for one launch
    scoring S·B pred images against B gt images: pred and gt (f32) each
    read once, three f32 per pred image written. Per pred plane: staging,
    sums and squared error (8 per pixel), running-sum 7-wide boxes of pc,
    pc², gc·pc in both directions (3 per output each) and the SSIM map (25
    per map pixel); per gt plane, once: its mean and centring (4 per pixel)
    and the boxes of gc, gc² (3 per output each)."""
    hp, wp = h - win + 1, w - win + 1
    n = s_n * b
    nbytes = n * h * w * c * pred_bytes + b * h * w * c * 4 + 3 * n * 4
    flops = (n * c * (8 * h * w + 9 * h * wp + 9 * hp * wp + 25 * hp * wp)
             + b * c * (4 * h * w + 6 * h * wp + 6 * hp * wp))
    return nbytes, flops


def bound(nbytes: int, flops: int) -> Tuple[float, str]:
    """(the least ms the card could take, which of the two binds), against
    HBM bandwidth and the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mfu_pct(flops: float, seconds: float,
            peak: float = BF16_FLOP_PER_S) -> float:
    """The share of `peak` that `flops` in `seconds` reach, in %."""
    return 100.0 * flops / seconds / peak


def roofline_pct(bound_ms: float, measured_ms: float) -> float:
    """The share of its roofline a kernel reaches: its bound over its
    measured time, in %."""
    return 100.0 * bound_ms / measured_ms
