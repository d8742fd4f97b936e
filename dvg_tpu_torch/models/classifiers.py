"""Action classifiers (counterpart of `dvg_tpu/models/classifiers.py`;
vestigial in the reference, shipped for parity): CNNBlockFrame and
CNNBlockFrame3 (reference models/cnn_block_frame.py:3-85), 3-D conv video
classifiers of a (15, 64, 64) clip, 6-way, on 1 and 3 channels; MLP (90 →
50 → 6) and MLP2 (10 → 6 → 6), latent classifiers (reference
models/linear_layer.py:9-48). Nothing on the card's path uses them.

Video is NDHWC (batch, frames, H, W, C) at the API, as in `dvg_tpu`;
inside, the 3-D convs run on NCDHW-shaped views, and the features are
flattened in NDHWC order, so fc1 takes `dvg_tpu`'s (2304, 128) weight as
it is. Dropout draws from an explicit `torch.Generator` and runs only in
train mode with one, as `dvg_tpu`'s runs only with an rng.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dvg_tpu_torch.models.layers import BN_EPS, BN_MOMENTUM


def dropout(y: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 − rate, drawn
    from `generator`; the identity without one."""
    if generator is None:
        return y
    keep = torch.rand(y.shape, generator=generator, device=y.device) \
        < 1.0 - rate
    return torch.where(keep, y / (1.0 - rate), torch.zeros_like(y))


class CNNBlockFrame(nn.Module):
    """Three Conv3d + BN + ReLU + max-pool blocks, then two Linears."""

    def __init__(self, in_channels: int = 1, num_classes: int = 6):
        super().__init__()
        self.conv1 = nn.Conv3d(in_channels, 16, (4, 5, 5))
        self.bn1 = nn.BatchNorm3d(16, BN_EPS, BN_MOMENTUM)
        self.conv2 = nn.Conv3d(16, 32, (4, 3, 3))
        self.bn2 = nn.BatchNorm3d(32, BN_EPS, BN_MOMENTUM)
        self.conv3 = nn.Conv3d(32, 64, (3, 3, 3))
        self.bn3 = nn.BatchNorm3d(64, BN_EPS, BN_MOMENTUM)
        self.fc1 = nn.Linear(2304, 128)
        self.fc2 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_rate: float = 0.5) -> torch.Tensor:
        """x (B, D, H, W, C) → logits (B, num_classes). In train mode BN
        normalizes by the batch's statistics and folds them into its
        running ones (momentum 0.1, unbiased variance)."""
        gen = generator if train else None
        h = x.permute(0, 4, 1, 2, 3)
        for conv, bn, pool in ((self.conv1, self.bn1, (1, 2, 2)),
                               (self.conv2, self.bn2, (2, 2, 2)),
                               (self.conv3, self.bn3, (2, 2, 2))):
            h = F.batch_norm(conv(h), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, training=train,
                             momentum=BN_MOMENTUM, eps=BN_EPS)
            h = dropout(F.max_pool3d(F.relu(h), pool), dropout_rate, gen)
        h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)
        h = dropout(F.relu(self.fc1(h)), dropout_rate, gen)
        return self.fc2(h)


class CNNBlockFrame3(CNNBlockFrame):
    """CNNBlockFrame on RGB clips."""

    def __init__(self, num_classes: int = 6):
        super().__init__(3, num_classes)


class MLP(nn.Module):
    """Linear → ReLU → Linear over a latent (B, in_dim)."""

    def __init__(self, in_dim: int = 90, hidden: int = 50,
                 num_classes: int = 6):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class MLP2(MLP):
    """The 10 → 6 → 6 latent classifier."""

    def __init__(self, num_classes: int = 6):
        super().__init__(10, 6, num_classes)
