"""Visualization: image grids, PNG and GIF writers, captions and borders
(counterpart of `dvg_tpu/utils/viz.py`), on the port's own codecs
(`_codecs.py`) and bitmap font, so neither PIL nor imageio is needed.

  * `image_grid`: nested lists of (H, W, C) images → one tiled image with
    `padding` white gutters; a list of lists stacks its rows vertically, a
    flat list concatenates horizontally (the reference's orientation).
  * `save_image`: the grid with 1-px gutters as an RGB PNG.
  * `save_gif`: one grid per frame, no outer gutters, looping.
  * `save_gif_with_text`: per frame, each caption drawn into its tile in
    black at (4, H − 32), the tiles concatenated with no gutters.
  * `add_border`: a frame inside a 1-px red or green (0.7) border with a
    30-px bottom strip for the caption.

Captions use a 5×7 bitmap font (6-px advance, 9-px line) kept here, so
their pixels differ from Pillow's default font; every other pixel equals
the JAX package's. Images are float arrays in [0, 1], (H, W, C) or (H, W).
In a distributed run only the coordinator writes files.
"""

from __future__ import annotations

import functools
import os
from typing import List, Sequence

import numpy as np

from dvg_tpu_torch.parallel.mesh import is_coordinator
from dvg_tpu_torch.utils._codecs import encode_gif, encode_png

# 5×7 glyphs, 7 rows of 5 bits (most significant bit leftmost) per glyph,
# two hex digits a row, in the order of _FONT_CHARS
_FONT_CHARS = (' !"#%\'()*+,-./0123456789:;<=>?@ABCDEFGHIJKLM'
               'NOPQRSTUVWXYZ[]_|abcdefghijklmnopqrstuvwxyz')
_FONT_ROWS = (
    "00000000000000040404040400040a0a0a000000000a0a1f0a1f0a0a18190204081303"
    "0404080000000002040808080402080402020204080004150e1504000004041f040400"
    "000000000c04080000001f00000000000000000c0c000102040810000e11131519110e"
    "040c040404040e0e11010204081f1f02040201110e02060a121f02021f101e0101110e"
    "0608101e11110e1f0102040808080e11110e11110e0e11110f01020c000c0c000c0c00"
    "000c0c000c04080204081008040200001f001f0000080402010204080e110102040004"
    "0e11010d15150e0e1111111f11111e11111e11111e0e11101010110e1c12111111121c"
    "1f10101e10101f1f10101e1010100e11101711110f1111111f1111110e04040404040e"
    "0702020202120c111214181412111010101010101f111b151511111111111915131111"
    "0e11111111110e1e11111e1010100e11111115120d1e11111e1412110f10100e01011e"
    "1f0404040404041111111111110e11111111110a041111111515150a11110a040a1111"
    "1111110a0404041f01020408101f0e08080808080e0e02020202020e0000000000001f"
    "0404040404040400000e010f110f1010161911111e00000e1010110e01010d1311110f"
    "00000e111f100e0609081c080808000f11110f010e1010161911111104000c0404040e"
    "0200060202120c101012141814120c04040404040e00001a1515111100001619111111"
    "00000e1111110e00001e111e101000000d130f01010000161910101000000e100e011e"
    "08081c080809060000111111130d00001111110a040000111115150a0000110a040a11"
    "000011110f010e00001f0204081f"
)
GLYPH_W, GLYPH_H, ADVANCE, LINE = 5, 7, 6, 9
# a character outside the font draws as a hollow box
_MISSING = np.array([[1] * 5] + [[1, 0, 0, 0, 1]] * 5 + [[1] * 5], bool)


def _glyph(ch: str) -> np.ndarray:
    i = _FONT_CHARS.find(ch)
    if i < 0:
        return _MISSING
    rows = bytes.fromhex(_FONT_ROWS[14 * i:14 * i + 14])
    return (np.array(list(rows), np.uint8)[:, None]
            >> np.arange(4, -1, -1)) & 1 == 1


@functools.lru_cache(maxsize=256)
def _text_pixels(text: str, x0: int, y0: int, h: int, w: int):
    """(ys, xs) of the pixels `text` sets on an h × w image, its first
    line's top-left corner at (x0, y0); '\\n' starts a line; pixels off
    the image are dropped. Cached: a GIF repeats its captions on every
    frame."""
    ys, xs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for li, line in enumerate(text.split("\n")):
        for ci, ch in enumerate(line):
            gy, gx = np.nonzero(_glyph(ch))
            ys.append(gy + y0 + li * LINE)
            xs.append(gx + x0 + ci * ADVANCE)
    ys, xs = np.concatenate(ys), np.concatenate(xs)
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    return ys[keep], xs[keep]


def _captioned_u8(img: np.ndarray, text: str) -> np.ndarray:
    """The (H, W, C) float tile through uint8, truncated as the reference's
    `np.uint8(img * 255)` round trip, with `text` in black at (4, H − 32)
    → (H, W, 3) uint8."""
    img = _to_hwc(np.asarray(img))
    u8 = np.uint8(img * 255)
    u8[_text_pixels(text, 4, img.shape[0] - 32, *img.shape[:2])] = 0
    return u8


def _to_hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def image_grid(inputs, padding: int = 1) -> np.ndarray:
    """Nested lists of images → a tiled (H, W, 3) image.

    A list of LISTS stacks its sub-grids vertically (one grid row per
    entry); a flat list of images concatenates horizontally. Gutters are
    `padding` px of white at this level only: nested sub-grids are composed
    with padding 1, as the reference's recursion does, so `save_gif`'s
    padding 0 removes only the outer gutters. A stacked (N, H, W, C) array
    counts as a flat list."""
    if isinstance(inputs, np.ndarray) and inputs.ndim == 4:
        inputs = list(inputs)
    if isinstance(inputs, (list, tuple)):
        tiles = [image_grid(e) for e in inputs]
        h = max(t.shape[0] for t in tiles)
        w = max(t.shape[1] for t in tiles)
        tiles = [_pad_to(t, h, w) for t in tiles]
        vert = (isinstance(inputs[0], (list, tuple))
                or (isinstance(inputs[0], np.ndarray)
                    and inputs[0].ndim == 4))
        axis = 0 if vert else 1
        gut_shape = ((padding, w, 3) if vert else (h, padding, 3))
        gutter = np.ones(gut_shape, np.float32)
        out: List[np.ndarray] = []
        for i, t in enumerate(tiles):
            if i:
                out.append(gutter)
            out.append(t)
        return np.concatenate(out, axis=axis)
    return _to_hwc(inputs)


def _pad_to(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ph, pw = h - img.shape[0], w - img.shape[1]
    return np.pad(img, ((0, ph), (0, pw), (0, 0)))


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _write(path: str, data: bytes) -> None:
    """Write `data` to `path` on the coordinator only (`parallel.
    is_coordinator`), so the ranks of a distributed run never race on one
    file."""
    if not is_coordinator():
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def save_image(path: str, grid) -> None:
    """The grid with 1-px gutters as an RGB PNG."""
    _write(path, encode_png(_to_uint8(image_grid(grid, padding=1))))


def save_gif(path: str, frames: Sequence, duration: float = 0.25) -> None:
    """frames: a sequence over time of images or nested grids, composed
    with no outer gutters; each frame shows `duration` seconds, looping."""
    _write(path, encode_gif(
        [_to_uint8(image_grid(f, padding=0)) for f in frames], duration))


def draw_text_on(img: np.ndarray, text: str) -> np.ndarray:
    """The (H, W, C) float tile through uint8 (truncated, as the
    reference's `np.uint8(img * 255)` round trip) with `text` drawn in black
    at (4, H − 32) → (H, W, 3) float32."""
    return _captioned_u8(img, text).astype(np.float32) / 255.0


def text_frames(gifs: Sequence[Sequence], texts: Sequence[Sequence[str]]
                ) -> List[np.ndarray]:
    """The uint8 frames `save_gif_with_text` encodes: per frame, every tile
    captioned (`draw_text_on`, kept in uint8, which its /255 round trip
    gives back exactly) and the tiles concatenated horizontally."""
    return [np.concatenate([_captioned_u8(img, txt)
                            for img, txt in zip(row_imgs, row_txts)], axis=1)
            for row_imgs, row_txts in zip(gifs, texts)]


def save_gif_with_text(path: str, gifs: Sequence[Sequence],
                       texts: Sequence[Sequence[str]],
                       duration: float = 0.25) -> None:
    """gifs[t][k] = image, texts[t][k] = its caption: `text_frames` as a
    looping GIF."""
    _write(path, encode_gif(text_frames(gifs, texts), duration))


def add_border(img: np.ndarray, color: str, pad: int = 1) -> np.ndarray:
    """An (H, W, C) frame inside a `pad`-px border, red or green at 0.7
    (black otherwise), with a 30-px bottom strip → (H + 2·pad + 30,
    W + 2·pad, 3) float32."""
    img = _to_hwc(np.asarray(img))
    h, w = img.shape[:2]
    out = np.zeros((h + 2 * pad + 30, w + 2 * pad, 3), np.float32)
    if color == "red":
        out[..., 0] = 0.7
    elif color == "green":
        out[..., 1] = 0.7
    out[pad:h + pad, pad:w + pad, :] = img
    return out
