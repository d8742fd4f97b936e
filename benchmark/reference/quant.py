"""The control: the reference in fp8 where the configurations state bf16,
the precision below.

Every convolution, transposed convolution and linear layer (the encoder,
the decoder, the LSTM) takes its input and weight rounded to float8 e4m3
with a per-tensor scale (the tensor's largest magnitude onto e4m3's 448),
as an fp8 GEMM's operands are; in a backward pass the gradient flowing out
of each rounded operand is rounded to e5m2 the same way. A generation's GP
sample and variance, which the configurations compute in bf16, have every
intermediate (the kernel row, the Cholesky factor, the whitened solve, the
sums of the variance, the mean, the sample) rounded to e4m3 alike.
Accumulation, BatchNorm, the LSTM's gates, the training step's GP and the
losses stay in f32, as the configurations keep them."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.nets import Ops

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


class FP8Ops(Ops):
    def conv(self, x, w, b, stride, pad):
        return F.conv2d(fp8(x), fp8(w), b, stride, pad)

    def conv_t(self, x, w, b, stride, pad):
        return F.conv_transpose2d(fp8(x), fp8(w), b, stride, pad)

    def linear(self, x, w, b):
        return F.linear(fp8(x), fp8(w), b)

    def gp_round(self, x):
        return fp8(x)
