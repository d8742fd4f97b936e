"""Clips made from `--seed` on the device, handed to the program and to the
reference alike.

  * "moving_mnist": stochastic Moving MNIST as the reference's data loader
    makes it (shgaurav1/DVG data/moving_mnist.py): `num_digits` 32-px
    digits on a 64-px canvas, a uniform start and integer velocity in
    [−4, 4], a wall contact reflecting the digit with its velocity redrawn,
    overlaps summed and clamped to 1. There is no MNIST file in the repo,
    so the digits come from a seeded procedural glyph bank (anti-aliased
    quadratic strokes), a copy of the program's own fallback made on the
    device. The trajectories (a few KB) are drawn on the host.
  * "uniform": i.i.d. U[0, 1) frames; the convolutions' work does not
    depend on content.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

GLYPHS = 256
DIGIT = 32
CANVAS = 64
STROKE_POINTS = 40


def glyph_bank(gen: torch.Generator, device, n: int = GLYPHS) -> torch.Tensor:
    """(n, 32, 32) f32 glyphs in [0, 1]: three quadratic strokes each, 40
    Gaussian dots (σ 1.37 px, the 28-px glyph's 1.2 at 32 px) along each."""
    p = 4.5 + (DIGIT - 9.0) * torch.rand((n, 3, 3, 2), generator=gen,
                                         device=device)
    t = torch.linspace(0.0, 1.0, STROKE_POINTS, device=device)[:, None]
    pts = ((1 - t) ** 2 * p[:, :, None, 0] + 2 * t * (1 - t)
           * p[:, :, None, 1] + t ** 2 * p[:, :, None, 2])  # (n, 3, P, 2)
    pts = pts.reshape(n, -1, 2)
    ax = torch.arange(DIGIT, dtype=torch.float32, device=device)
    sig2 = 2.0 * (1.2 * DIGIT / 28.0) ** 2
    gy = torch.exp(-(ax[None, None, :] - pts[..., 0, None]) ** 2 / sig2)
    gx = torch.exp(-(ax[None, None, :] - pts[..., 1, None]) ** 2 / sig2)
    return torch.einsum("npy,npx->nyx", gy, gx).clamp_(0.0, 1.0)


def _trajectories(rng: np.random.Generator, t_len: int, n: int,
                  lim: int) -> np.ndarray:
    """(T, n, 2) top-left corners of n bouncing digits."""
    pos = rng.integers(0, lim, (n, 2))
    vel = rng.integers(-4, 5, (n, 2))
    traj = np.zeros((t_len, n, 2), np.int64)
    for t in range(t_len):
        under, over = pos < 0, pos >= lim
        hit = under | over
        if hit.any():
            mag = rng.integers(1, 5, (n, 2))
            other = rng.integers(-4, 5, (n, 2))
            away = np.where(under, mag, -mag)
            y_hit, x_hit = hit[:, :1], hit[:, 1:]
            dy = np.where(x_hit, other[:, :1],
                          np.where(y_hit, away[:, :1], vel[:, :1]))
            dx = np.where(x_hit, away[:, 1:],
                          np.where(y_hit, other[:, 1:], vel[:, 1:]))
            vel = np.concatenate([dy, dx], axis=1)
            pos = np.where(under, 0, np.where(over, lim - 1, pos))
        traj[t] = pos
        pos = pos + vel
    return traj


def moving_mnist(seed: int, batches: int, t_len: int, b: int,
                 num_digits: int, device) -> torch.Tensor:
    """(batches, T, B, 64, 64, 1) f32 clips, every clip different."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bank = glyph_bank(gen, device)
    n = batches * b * num_digits
    rng = np.random.default_rng([seed, 0xD161])
    traj = torch.from_numpy(_trajectories(rng, t_len, n, CANVAS - DIGIT)
                            ).to(device)
    idx = torch.randint(0, GLYPHS, (n,), generator=gen, device=device)
    sprites = bank[idx]                                    # (n, 32, 32)
    ar = torch.arange(DIGIT, device=device)
    ys = traj[:, :, 0, None] + ar                          # (T, n, 32)
    xs = traj[:, :, 1, None] + ar
    clip = torch.arange(n, device=device) // num_digits    # batch·B + row
    lin = (((torch.arange(t_len, device=device)[:, None] * (batches * b)
             + clip[None, :])[:, :, None, None] * CANVAS
            + ys[:, :, :, None]) * CANVAS + xs[:, :, None, :])
    flat = torch.zeros(t_len * batches * b * CANVAS * CANVAS,
                       device=device)
    flat.index_add_(0, lin.reshape(-1),
                    sprites[None].expand(t_len, -1, -1, -1).reshape(-1))
    x = flat.reshape(t_len, batches, b, CANVAS, CANVAS, 1).clamp_(0.0, 1.0)
    return x.transpose(0, 1).contiguous()


def uniform(seed: int, batches: int, t_len: int, b: int, size: int,
            channels: int, device) -> torch.Tensor:
    """(batches, T, B, size, size, C) f32 in [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((batches, t_len, b, size, size, channels),
                      generator=gen, device=device)


def clips(inputs: Dict, spec: Dict, seed: int, batches: int, t_len: int,
          b: int, device) -> torch.Tensor:
    """The configuration's clips: `inputs` is its "inputs" entry."""
    if inputs["kind"] == "moving_mnist":
        return moving_mnist(seed, batches, t_len, b, inputs["num_digits"],
                            device)
    if inputs["kind"] == "uniform":
        return uniform(seed, batches, t_len, b, spec["image_width"],
                       spec["channels"], device)
    raise ValueError(f"unknown input kind {inputs['kind']!r}")
