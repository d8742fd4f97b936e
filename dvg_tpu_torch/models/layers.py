"""Layer pieces of the port: conv blocks with train-mode BatchNorm and
its activation (`batch_norm_act`: `ops/batchnorm.py`, K4 on the card) and
its fold into the conv, the torch-style transposed conv, LeakyReLU 0.2, the
VGG backbone's 2×2 max-pool and nearest ×2 upsample, and the init law. The
eval form of a block is its BN-folded one (`fold_conv_bn`): the conv runs
without its bias and ends in one epilogue pass (`conv_act`,
`skip_epilogue`: `ops/epilogue.py`, K3 on the card) that adds the bias and
a split conv's skip half and applies the activation; `ConvBlock.pooled`
ends one whose full map nothing reads in the max-pool too.

Counterpart of `dvg_tpu/models/layers.py`. Weights are kept in torch's own
layouts (Conv2d (O, I, kh, kw), ConvTranspose2d (I, O, kh, kw)); the JAX
package's HWIO kernels map onto them in `dvg_tpu_torch/convert.py`.
Activations inside the port are NCHW-shaped views of NHWC memory
(`channels_last`), so the public NHWC tensors cross into and out of the
convs without a copy.

Init (the JAX package's law, drawn from an explicit torch.Generator): conv
and linear weights ~ N(0, 0.02), biases 0; BN scale ~ N(1, 0.02), bias 0,
running mean 0 and variance 1.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dvg_tpu_torch.ops import batchnorm as BN
from dvg_tpu_torch.ops.epilogue import (NEGATIVE_SLOPE, activate,
                                         conv_epilogue, conv_epilogue_pool)
from dvg_tpu_torch.parallel.collectives import all_reduce_sum, world_size

WEIGHT_STD = 0.02
BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# per-call batch statistics of one train-mode BN: (mean, unbiased variance),
# each (calls, C) in at least f32
BNStats = Tuple[torch.Tensor, torch.Tensor]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least f32: the accumulation dtype of statistics and losses (f64
    stays f64)."""
    return torch.promote_types(dtype, torch.float32)


def f32up(t: torch.Tensor) -> torch.Tensor:
    """t in at least f32 (f64 stays f64)."""
    return t.to(acc_dtype(t.dtype))


def cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`t` in the compute dtype (differentiable; `dtype` None keeps it)."""
    return t if dtype is None else t.to(dtype)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, NEGATIVE_SLOPE)


def max_pool2d(x: torch.Tensor) -> torch.Tensor:
    """2×2 max-pool, stride 2, VALID, on an NCHW-shaped tensor."""
    return F.max_pool2d(x, 2, 2)


def upsample_nearest2d(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour ×2 upsample of an NCHW-shaped tensor (keeps its
    memory format)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor → NCHW-shaped view (channels_last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW-shaped tensor → NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)


def conv_apply(conv: nn.Module, x: torch.Tensor,
               dtype: Optional[torch.dtype] = None,
               bias: bool = True) -> torch.Tensor:
    """`conv` (Conv2d or ConvTranspose2d) on x with its weight and bias cast
    to `dtype` by a differentiable cast, so the gradient reaches the f32
    master weights; without its bias where `bias` is False."""
    w = cast(conv.weight, dtype)
    b = cast(conv.bias, dtype) if bias else None
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, conv.stride, conv.padding)
    return F.conv2d(x, w, b, conv.stride, conv.padding)


def conv_act(conv: nn.Module, x: torch.Tensor, act: str) -> torch.Tensor:
    """Eval-mode `conv` on x, then its bias and the activation `act` in one
    epilogue pass over the conv's output (`ops.epilogue`: K3 on the
    card)."""
    return conv_epilogue(conv_apply(conv, x, bias=False), conv.bias, None,
                         act)


def skip_epilogue(y: torch.Tensor, bias: torch.Tensor, pre: torch.Tensor,
                  act: str) -> torch.Tensor:
    """The epilogue of a split conv: its input half y (NCHW-shaped) plus its
    precomputed skip half `pre` (NHWC), the bias and `act`, in one pass.
    Both go to the epilogue in channels_last memory: a no-op for the model
    as `prepare()` leaves it (channels_last weights, so every conv output
    is), a copy for one whose weights are not (its 1×1 → 4×4 head gives
    NCHW)."""
    cl = torch.channels_last
    return conv_epilogue(y.contiguous(memory_format=cl), bias,
                         nchw(pre).contiguous(memory_format=cl), act)


def batch_norm_train(y: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, calls: int, eps: float = BN_EPS,
                     group=None) -> Tuple[torch.Tensor, BNStats]:
    """Train-mode BatchNorm with per-call statistics, in stock ops: y
    (calls·b, C, H, W) holds `calls` batches of b, each normalized over its
    own (b, H, W) by its biased variance. The statistics and the affine run
    in at least f32 and the output comes back in y's dtype, as `dvg_tpu`'s
    batchnorm_apply. Returns (out, (batch mean, unbiased variance)), both
    (calls, C), detached, for the running-statistics fold; the buffers are
    left alone. Without a group it is `ops.batchnorm.bn_plain`.

    Under a process `group` (data parallel, every rank holding b rows of
    each call) the statistics are the global batch's, in `dvg_tpu`'s
    two-pass form: the mean all-reduced, then the mean of (y − μ)²
    all-reduced, the unbiased count the global one. Both reductions are
    differentiable all-reduces, so the backward is the global-batch BN's."""
    if group is None:
        out, stats = BN.bn_plain(y, weight, bias, calls, eps)
        return out, (stats[0].detach(), stats[3].detach())
    at = acc_dtype(y.dtype)
    y5 = y.unflatten(0, (calls, y.shape[0] // calls)).to(at)
    w = world_size(group)
    n = y5.shape[1] * y5.shape[3] * y5.shape[4] * w
    mean = all_reduce_sum(y5.mean(dim=(1, 3, 4)), group) / w
    var = all_reduce_sum(((y5 - mean[:, None, :, None, None]) ** 2
                          ).mean(dim=(1, 3, 4)), group) / w
    scale = torch.rsqrt(var + eps) * weight.to(at)
    out = ((y5 - mean[:, None, :, None, None]) * scale[:, None, :, None, None]
           + bias.to(at)[:, None, None])
    unbiased = var.detach() * (n / max(n - 1, 1))
    return out.to(y.dtype).flatten(0, 1), (mean.detach(), unbiased)


def batch_norm_act(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   calls: int, act: str, group=None
                   ) -> Tuple[torch.Tensor, BNStats]:
    """`batch_norm_train` followed by the activation `act` ("leaky_relu" or
    "tanh") → (out, per-call statistics). On one device it is one operator
    (`ops.batchnorm.bn_act`: K4 on the card, whose kernels take y in
    channels_last memory, a no-op for the train step's maps); under a
    process `group` the global-batch composition, whose statistics are
    all-reduces that no single-device kernel holds."""
    if group is not None:
        out, stats = batch_norm_train(y, weight, bias, calls, group=group)
        return activate(out, act), stats
    if y.is_cuda:
        y = y.contiguous(memory_format=torch.channels_last)
    return BN.bn_act(y, weight, bias, calls, act, BN_EPS)


class ConvBlock(nn.Module):
    """A conv (plain or transposed) followed by BatchNorm. `train_forward`
    runs train mode with per-call batch statistics; the eval forms,
    `forward` and `pooled`, run only after `fold_conv_bn` has folded the
    BN into the conv (`bn is None`), and refuse a block that holds it."""

    def __init__(self, conv: nn.Module, bn: Optional[nn.BatchNorm2d]):
        super().__init__()
        self.conv = conv
        self.bn = bn

    def _folded(self) -> nn.Module:
        if self.bn is not None:
            raise ValueError("eval forward requires BN-folded params — call "
                             "model.fold_inference_params() or fold_() first")
        return self.conv

    def forward(self, x: torch.Tensor, act: str = "none") -> torch.Tensor:
        """Eval mode: the conv, then its bias and the activation `act` (a
        key of `ops.epilogue.ACTS`) in one epilogue pass (`conv_act`)."""
        return conv_act(self._folded(), x, act)

    def pooled(self, x: torch.Tensor, act: str = "none") -> torch.Tensor:
        """`max_pool2d(forward(x, act))`, bitwise, in one epilogue pass that
        writes only the pooled map (`ops.epilogue.conv_epilogue_pool`: K3's
        pooled form on the card), from the conv's output in channels_last
        memory (a no-op for the model as `prepare()` leaves it)."""
        conv = self._folded()
        y = conv_apply(conv, x, bias=False)
        return conv_epilogue_pool(
            y.contiguous(memory_format=torch.channels_last), conv.bias, act)

    def train_forward(self, x: torch.Tensor, calls: int, act: str,
                      dtype: Optional[torch.dtype] = None, group=None
                      ) -> Tuple[torch.Tensor, BNStats]:
        """Conv, then train-mode BN over each of the `calls` batches of x and
        the activation `act` (`batch_norm_act`), every weight cast to
        `dtype` → (out, per-call statistics), global over `group`'s ranks
        under one."""
        return batch_norm_act(conv_apply(self.conv, x, dtype),
                              cast(self.bn.weight, dtype),
                              cast(self.bn.bias, dtype), calls, act, group)


def conv_block(in_ch: int, out_ch: int, k: int, stride: int,
               padding: int) -> ConvBlock:
    """Conv2d(k, stride, padding) + BN (activation applied by the caller).
    k=4, s=2, p=1 halves the resolution (DCGAN's stages); k=3, s=1, p=1
    keeps it (VGG's groups); k=4, s=1, p=0 maps 4×4 → 1×1 (the heads)."""
    return ConvBlock(nn.Conv2d(in_ch, out_ch, k, stride, padding),
                     nn.BatchNorm2d(out_ch, eps=BN_EPS))


def upconv_block(in_ch: int, out_ch: int, k: int, stride: int,
                 torch_padding: int) -> ConvBlock:
    """ConvTranspose2d(k, stride, torch_padding) + BN. Output size
    (in-1)·stride − 2·torch_padding + k: k=4, s=2, p=1 doubles the
    resolution; k=4, s=1, p=0 maps 1×1 → 4×4."""
    return ConvBlock(nn.ConvTranspose2d(in_ch, out_ch, k, stride,
                                        torch_padding),
                     nn.BatchNorm2d(out_ch, eps=BN_EPS))


def fold_conv_bn(block: ConvBlock, eps: float = BN_EPS) -> ConvBlock:
    """Fold the eval-mode BN into the conv, in f32:
      w' = w · f,   b' = (b − μ)·f + β,   f = γ/√(σ²+ε).
    The BN scales the conv's OUTPUT channels: dim 0 of a Conv2d weight,
    dim 1 of a ConvTranspose2d weight. Returns a new block without BN."""
    conv, bn = block.conv, block.bn
    f = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
    if isinstance(conv, nn.ConvTranspose2d):
        scale = f[None, :, None, None]
    else:
        scale = f[:, None, None, None]
    folded = copy.deepcopy(conv)
    with torch.no_grad():
        folded.weight.copy_(conv.weight.float() * scale)
        folded.bias.copy_((conv.bias.float() - bn.running_mean.float()) * f
                          + bn.bias.float())
    return ConvBlock(folded, None)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init law over every conv, BN and linear layer of
    `module`, in `named_modules` order (LSTM cells and the GP initialise
    themselves: models/rnn.py, models/gp.py)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                          nn.Linear)):
            m.weight.normal_(0.0, WEIGHT_STD, generator=generator)
            m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.weight.normal_(1.0, WEIGHT_STD, generator=generator)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
