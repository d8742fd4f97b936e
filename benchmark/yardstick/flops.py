"""FLOPs counted from the ops' shapes (frozen copy of
`chip_smoke.py::counted_flops`)."""

from __future__ import annotations


def counted_flops(fn) -> int:
    """The FLOPs of the convolutions and matrix products fn() runs, from
    `torch.utils.flop_counter`. Ops it has no formula for count 0: K1 and K2
    (custom ops, not torch's), cuDNN's fused LSTM recurrence and the GP's
    Cholesky and triangular solves are left out."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()
