"""Layer pieces of the port: conv blocks with eval-mode BatchNorm, the
torch-style transposed conv, LeakyReLU 0.2, BN folding and the init law.

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
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

WEIGHT_STD = 0.02
BN_EPS = 1e-5
NEGATIVE_SLOPE = 0.2


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, NEGATIVE_SLOPE)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor → NCHW-shaped view (channels_last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW-shaped tensor → NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)


class ConvBlock(nn.Module):
    """A conv (plain or transposed) followed by eval-mode BatchNorm. After
    `fold_conv_bn` the BN is gone and the conv carries it (`bn is None`)."""

    def __init__(self, conv: nn.Module, bn: Optional[nn.BatchNorm2d]):
        super().__init__()
        self.conv = conv
        self.bn = bn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.bn is None:
            return y
        return F.batch_norm(y, self.bn.running_mean, self.bn.running_var,
                            self.bn.weight, self.bn.bias, training=False,
                            eps=BN_EPS)


def conv_block(in_ch: int, out_ch: int, k: int, stride: int,
               padding: int) -> ConvBlock:
    """Conv2d(k, stride, padding) + BN (activation applied by the caller)."""
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
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            m.weight.normal_(0.0, WEIGHT_STD, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.normal_(1.0, WEIGHT_STD, generator=generator)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
