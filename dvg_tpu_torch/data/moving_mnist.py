"""Moving-MNIST: on-the-fly bouncing-digit video generator (counterpart of
`dvg_tpu/data/moving_mnist.py`, same names, the same numpy draws from the
same seeds, so the same data bit for bit).

  * `num_digits` (default 2) 32-px digits bouncing on a 64-px canvas,
    uniform start position and integer velocity in [-4, 4];
  * on wall contact the digit reflects; in the default stochastic mode the
    outgoing velocity is redrawn at random;
  * overlapping digits are summed, then clamped to 1;
  * every `ds[i]` draws from `np.random.default_rng((seed, index))`, a pure
    function of (seed, index), and `sample_batch` from (seed, start,
    batch_size);
  * digits come from raw MNIST idx files under `data_root` when present,
    else from a deterministic procedural glyph bank.

`device_batch` assembles a batch on a torch device by one scatter-add of
the sprites; `_resize_bilinear` is Pillow's BILINEAR resize of uint8
images reimplemented in integer numpy, so no PIL is needed.
"""

from __future__ import annotations

import gzip
import os
import struct
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

_MNIST_DIRS = ("", "MNIST/raw/", "mnist/")


def _mnist_file_exists(data_root: str, train: bool) -> bool:
    stem = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    return any(
        os.path.exists(os.path.join(data_root, d + stem + suffix))
        for d in _MNIST_DIRS for suffix in ("", ".gz"))


def _load_mnist_images(data_root: str,
                       train: bool = True) -> Optional[np.ndarray]:
    """Raw MNIST idx images (optionally .gz) of the split → (N, 28, 28)
    float32 in [0, 1]; None when no file of the split exists. A file that is
    present but unreadable raises: a glyph fallback would silently swap the
    data distribution under a data_root the caller believes holds MNIST."""
    stem = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    corrupt = []
    for rel in (d + stem for d in _MNIST_DIRS):
        for suffix, opener in (("", open), (".gz", gzip.open)):
            path = os.path.join(data_root, rel + suffix)
            if not os.path.exists(path):
                continue
            with opener(path, "rb") as f:
                header = f.read(16)
                if len(header) < 16:
                    corrupt.append(path)
                    continue
                magic, n, rows, cols = struct.unpack(">IIII", header)
                if magic != 2051:
                    corrupt.append(path)
                    continue
                buf = f.read(n * rows * cols)
            arr = np.frombuffer(buf, dtype=np.uint8).reshape(n, rows, cols)
            return arr.astype(np.float32) / 255.0
    if corrupt:
        raise ValueError(
            f"MNIST idx file(s) present but unreadable (bad/short magic "
            f"header, expected 2051): {corrupt} — re-download the file; "
            "refusing to fall back to procedural glyphs for an explicitly "
            "provided data_root")
    return None


def _procedural_digits(num: int = 256, size: int = 28,
                       seed: int = 1234) -> np.ndarray:
    """Deterministic digit-like glyphs (anti-aliased quadratic strokes),
    used when no MNIST file is on disk; train and test use different seeds,
    so the splits are glyph-disjoint."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    glyphs = np.zeros((num, size, size), np.float32)
    for i in range(num):
        g = np.zeros((size, size), np.float32)
        for _ in range(rng.integers(2, 5)):
            p = rng.uniform(4, size - 4, (3, 2)).astype(np.float32)
            t = np.linspace(0, 1, 40, dtype=np.float32)[:, None]
            pts = ((1 - t) ** 2 * p[0] + 2 * t * (1 - t) * p[1] + t ** 2 * p[2])
            for cy, cx in pts:
                g += np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2)
                              / (2.0 * 1.2 ** 2)))
        glyphs[i] = np.clip(g, 0.0, 1.0)
    return glyphs


class MovingMNIST:
    """Map-style dataset: `ds[i]` → ((T, H, W, 1) float32 in [0,1], 0)."""

    def __init__(self, train: bool = True, data_root: str = "",
                 seq_len: int = 20, num_digits: int = 2,
                 image_size: int = 64, digit_size: int = 32,
                 deterministic: bool = False, seed: int = 1,
                 epoch_size: int = 0):
        self.seq_len = seq_len
        self.num_digits = num_digits
        self.image_size = image_size
        self.digit_size = digit_size
        self.deterministic = deterministic
        self.channels = 1
        # train/test draw from disjoint RNG streams
        self.seed = (seed * 2 + (0 if train else 1)) * 0x9E3779B1
        self._len = epoch_size if epoch_size else (60000 if train else 10000)

        digits = (_load_mnist_images(data_root, train=train)
                  if data_root else None)
        if digits is None:
            if data_root:
                # an explicit data_root promises real MNIST: warn, and refuse
                # outright when only the other split is there, since train
                # and eval would then see different data distributions
                split, stem = (("train", "train-images-idx3-ubyte") if train
                               else ("test", "t10k-images-idx3-ubyte"))
                msg = (f"MNIST {split}-split images ({stem}[.gz]) not found "
                       f"under {data_root!r} (searched {_MNIST_DIRS}); "
                       "falling back to procedural glyphs for this split")
                if _mnist_file_exists(data_root, train=not train):
                    raise FileNotFoundError(
                        msg + " — but the OTHER split's idx file IS present, "
                        "so train and eval would use different data "
                        "distributions. Download the missing idx file "
                        "(both splits ship in every MNIST mirror).")
                warnings.warn(msg, stacklevel=2)
            digits = _procedural_digits(seed=1234 if train else 4321)
        if digit_size != digits.shape[-1]:
            digits = _resize_bilinear(digits, digit_size)
        self.digits = digits

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        rng = np.random.default_rng((self.seed, index))
        x = self._generate(rng, 1)[:, 0]
        return x, 0

    def sample_batch(self, batch_size: int, start_index: int = 0) -> np.ndarray:
        """(T, B, H, W, 1) float32 batch, deterministic in (seed,
        start_index, batch_size): the whole batch draws from one stream, so
        row b is not `ds[start_index + b]`."""
        rng = np.random.default_rng((self.seed, start_index, batch_size))
        return self._generate(rng, batch_size)

    def batch_parts(self, batch_size: int, start_index: int = 0):
        """The host side of device assembly: (trajectories (T, n, 2) int32,
        sprites (n, dsz, dsz) f32), n = batch_size · num_digits, from the
        same stream as `sample_batch`."""
        rng = np.random.default_rng((self.seed, start_index, batch_size))
        traj, sprites = self._trajectories(rng, batch_size)
        return traj.astype(np.int32), sprites

    def device_batch(self, batch_size: int, start_index: int = 0,
                     device="cuda") -> torch.Tensor:
        """`sample_batch`'s (T, B, H, W, 1) batch assembled on `device`: the
        trajectories and sprites (a few KB) cross once, and one scatter-add
        blits every sprite."""
        traj, sprites = self.batch_parts(batch_size, start_index)
        return _assemble(torch.from_numpy(traj).to(device),
                         torch.from_numpy(sprites).to(device),
                         batch_size, self.image_size, self.num_digits)

    def _trajectories(self, rng: np.random.Generator, b: int):
        """Digit ids and bouncing trajectories: ((T, n, 2) positions,
        (n, dsz, dsz) sprites), n = b · num_digits."""
        t_len, size, dsz, nd = (self.seq_len, self.image_size,
                                self.digit_size, self.num_digits)
        lim = size - dsz
        n = b * nd
        idx = rng.integers(0, len(self.digits), n)
        sprites = self.digits[idx]                      # (n, dsz, dsz)
        pos = rng.integers(0, lim, (n, 2)).astype(np.int64)       # (y, x)
        vel = rng.integers(-4, 5, (n, 2)).astype(np.int64)

        traj = np.zeros((t_len, n, 2), np.int64)
        for t in range(t_len):
            # a bounce triggers at pos < 0 or pos >= lim and clamps
            under = pos < 0
            over = pos >= lim
            if under.any() or over.any():
                if self.deterministic:
                    vel = np.where(under | over, -vel, vel)
                else:
                    # each colliding axis redraws away from its wall and the
                    # other axis redraws over [-4, 4]; on a corner hit the x
                    # branch's full-range dy redraw overwrites the y
                    # branch's away-from-wall dy, as in the reference
                    new_mag = rng.integers(1, 5, (n, 2))
                    new_other = rng.integers(-4, 5, (n, 2))
                    away = np.where(under, new_mag, -new_mag)
                    hit = under | over
                    y_hit, x_hit = hit[:, 0:1], hit[:, 1:2]
                    dy = np.where(x_hit, new_other[:, 0:1],
                                  np.where(y_hit, away[:, 0:1], vel[:, 0:1]))
                    dx = np.where(x_hit, away[:, 1:2],
                                  np.where(y_hit, new_other[:, 1:2],
                                           vel[:, 1:2]))
                    vel = np.concatenate([dy, dx], axis=1)
                pos = np.where(under, 0, np.where(over, lim - 1, pos))
            traj[t] = pos
            pos = pos + vel
        return traj, sprites

    def _generate(self, rng: np.random.Generator, b: int) -> np.ndarray:
        t_len, size, dsz, nd = (self.seq_len, self.image_size,
                                self.digit_size, self.num_digits)
        traj, sprites = self._trajectories(rng, b)
        # one fancy-indexed add per (frame, digit slot): within a statement
        # every (row, y, x) target is unique, so the buffered += is exact
        ar = np.arange(dsz)
        ys = traj[:, :, 0, None] + ar                   # (T, n, dsz)
        xs = traj[:, :, 1, None] + ar
        rows = np.arange(b)[:, None, None]
        x = np.zeros((t_len, b, size, size, 1), np.float32)
        spr = sprites.reshape(b, nd, dsz, dsz)
        ys = ys.reshape(t_len, b, nd, dsz)
        xs = xs.reshape(t_len, b, nd, dsz)
        for t in range(t_len):
            for d in range(nd):
                x[t, rows, ys[t, :, d, :, None], xs[t, :, d, None, :], 0] \
                    += spr[:, d]
        np.clip(x, 0.0, 1.0, out=x)
        return x


def _assemble(traj: torch.Tensor, sprites: torch.Tensor, b: int, size: int,
              nd: int) -> torch.Tensor:
    """Scatter-add the sprites onto zero canvases: traj (T, n, 2) int32,
    sprites (n, d, d) f32 → (T, B, size, size, 1) f32 clamped to [0, 1]."""
    t_len, n = traj.shape[0], traj.shape[1]
    dsz = sprites.shape[-1]
    dev = traj.device
    ar = torch.arange(dsz, device=dev)
    traj = traj.long()
    ys = traj[:, :, 0, None] + ar                       # (T, n, d)
    xs = traj[:, :, 1, None] + ar
    bi = torch.arange(n, device=dev) // nd              # (n,)
    lin = (((torch.arange(t_len, device=dev)[:, None] * b + bi[None, :])
            [:, :, None, None] * size + ys[:, :, :, None]) * size
           + xs[:, :, None, :])
    flat = torch.zeros(t_len * b * size * size, dtype=torch.float32,
                       device=dev)
    vals = sprites.float()[None].expand(t_len, n, dsz, dsz)
    flat.index_add_(0, lin.reshape(-1), vals.reshape(-1))
    return flat.reshape(t_len, b, size, size, 1).clamp_(0.0, 1.0)


# Pillow's fixed-point resample: coefficients carry 22 fractional bits, so
# an 8-bit pixel times a coefficient fits in 32 bits with room for a sum
_PRECISION_BITS = 32 - 8 - 2


def _resample_coeffs(in_size: int, out_size: int):
    """Pillow's `precompute_coeffs` for the BILINEAR (triangle, support 1)
    filter, then its 8-bit normalization: → (xmin (out,), weights (out, k)
    int64 fixed point), weight j of output x on input xmin[x] + j."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale              # the support scales on a reduce
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    j = np.arange(ksize)
    t = np.abs((j[None, :] + xmin[:, None] - center[:, None] + 0.5)
               * (1.0 / filterscale))
    w = np.where((t < 1.0) & (j[None, :] < xmax[:, None]), 1.0 - t, 0.0)
    ww = np.zeros((out_size, 1))
    for k in range(ksize):                   # C's left-to-right sum
        ww[:, 0] += w[:, k]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    return xmin, fixed.astype(np.int64)


def _resample_axis(u8: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along `axis`: the weighted sum of
    the taps plus 1 << 21, shifted down 22 bits and clipped to [0, 255]."""
    in_size = u8.shape[axis]
    xmin, w = _resample_coeffs(in_size, out_size)
    src = np.moveaxis(u8, axis, -1).astype(np.int64)
    idx = np.minimum(xmin[:, None] + np.arange(w.shape[1])[None, :],
                     in_size - 1)                     # zero-weight taps clamp
    acc = (src[..., idx] * w).sum(axis=-1) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_u8(u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pillow's `Image.resize((out_w, out_h), BILINEAR)` of each uint8
    image of `u8`, (N, H, W) or (N, H, W, C): the horizontal pass first,
    then the vertical one, each rounded to uint8, as Pillow's two-pass
    resample does."""
    chan = u8.ndim == 4
    x = u8 if chan else u8[..., None]
    if x.shape[2] != out_w:
        x = _resample_axis(x, out_w, axis=2)
    if x.shape[1] != out_h:
        x = _resample_axis(x, out_h, axis=1)
    return x if chan else x[..., 0]


def _resize_bilinear(imgs: np.ndarray, out: int) -> np.ndarray:
    """The 28→32 digit resize of the reference's `transforms.Scale(32)`:
    Pillow BILINEAR on the uint8 image, then /255 — Pillow rounds the
    interpolated values to uint8 before the division, so resizing the float
    image directly would differ in the low bits."""
    u8 = (np.clip(imgs, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return resize_u8(u8, out, out).astype(np.float32) / 255.0
