"""SSIM, PSNR and MSE as the reference's evaluation scores them
(skimage ≤ 0.17 compare_ssim / compare_psnr on float images): a uniform
7×7 window, unbiased local covariances (49/48), data range 2,
C1 = (0.01·2)², C2 = (0.03·2)², PSNR = 10·log10(4 / max(mse, 1e-12)).
A multi-channel image is scored per channel and the channels averaged."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

WIN = 7
RANGE = 2.0
C1 = (0.01 * RANGE) ** 2
C2 = (0.03 * RANGE) ** 2


def _box(x: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape((-1, 1) + x.shape[-2:]), WIN, stride=1)
    return y.reshape(lead + y.shape[-2:])


def scores(gt: torch.Tensor, pred: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gt (B, H, W, C), pred (K, B, H, W, C) → (ssim, psnr, mse), each
    (K, B) f32."""
    g = gt.float().permute(0, 3, 1, 2)[None]
    p = pred.float().permute(0, 1, 4, 2, 3)
    g = g.expand_as(p)
    cov = WIN * WIN / (WIN * WIN - 1.0)
    ux, uy = _box(g), _box(p)
    vx = cov * (_box(g * g) - ux * ux)
    vy = cov * (_box(p * p) - uy * uy)
    vxy = cov * (_box(g * p) - ux * uy)
    s = ((2 * ux * uy + C1) * (2 * vxy + C2)
         / ((ux * ux + uy * uy + C1) * (vx + vy + C2))).mean((-2, -1))
    mse = ((g - p) ** 2).mean((-2, -1))
    psnr = 10.0 * torch.log10(RANGE ** 2 / torch.clamp(mse, min=1e-12))
    return s.mean(-1), psnr.mean(-1), mse.mean(-1)
