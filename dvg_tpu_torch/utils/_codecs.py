"""PNG decoding and encoding and GIF encoding in numpy and the standard
library (`zlib`, `binascii.crc32`), so the port reads and writes images
where neither PIL nor imageio is installed.

  * `decode_png`: 8-bit gray, gray + alpha, RGB, RGBA and palette
    (1/2/4/8-bit) images, non-interlaced, all five row filters. Anything
    else raises, naming the file.
  * `encode_png`: 8-bit RGB, filter 0 on every row, zlib level 6.
  * `encode_gif`: GIF89a, looping, one local palette per frame. The
    palette is exact when a frame has at most 256 colours; otherwise
    `quantize` maps every channel into bins of 2**s values at the smallest
    shift s that leaves at most 256 occupied bins, and each colour to its
    bin's centre, so no channel moves by more than 2**(s-1). The LZW
    stream holds only 9-bit literal codes with a CLEAR code before every
    254 of them, so the decoder's table never outgrows 9-bit codes and the
    encoding is a few vectorized numpy passes.
"""

from __future__ import annotations

import binascii
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → (mode, channels, bit depths read)
_PNG_TYPES = {0: ("L", 1, (8,)), 2: ("RGB", 3, (8,)),
              3: ("P", 1, (1, 2, 4, 8)), 4: ("LA", 2, (8,)),
              6: ("RGBA", 4, (8,))}


class PNGError(ValueError):
    pass


def _chunks(data: bytes, name: str):
    if data[:8] != PNG_SIGNATURE:
        raise PNGError(f"{name}: not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise PNGError(f"{name}: truncated {ctype!r} chunk")
        if binascii.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"{name}: CRC mismatch in {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise PNGError(f"{name}: no IEND chunk (truncated file)")


def _unfilter(raw: bytes, height: int, stride: int, bpp: int,
              name: str) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) →
    (height, stride) uint8."""
    if len(raw) < height * (stride + 1):
        raise PNGError(f"{name}: image data ends early ({len(raw)} bytes "
                       f"for {height} rows of {stride + 1})")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:          # Sub: a running sum per byte of a pixel
            pad = (-stride) % bpp
            cur = np.cumsum(np.concatenate([line, np.zeros(pad, np.uint8)])
                            .reshape(-1, bpp), axis=0, dtype=np.uint8
                            ).reshape(-1)[:stride]
        elif ftype == 2:          # Up
            cur = line + prior
        elif ftype in (3, 4):     # Average, Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise PNGError(f"{name}: unknown row filter {int(ftype)} in row "
                           f"{y}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes, name: str = "<png>"):
    """PNG bytes → (pixels, mode, palette): pixels (H, W, C) uint8 with
    mode "L", "LA", "RGB", "RGBA" or "P" (C = 1, 2, 3, 4, 1); palette
    (N, 3) uint8 for "P", else None. Raises `PNGError`, naming `name`, for
    16-bit, interlaced, low-bit gray and malformed files."""
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError(f"{name}: no IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][2]:
        raise PNGError(f"{name}: unsupported PNG colour type {ctype} at "
                       f"bit depth {depth} (read: 8-bit gray, gray+alpha, "
                       "RGB, RGBA; palette at 1/2/4/8 bits)")
    if interlace:
        raise PNGError(f"{name}: interlaced PNG is not supported")
    if comp or filt:
        raise PNGError(f"{name}: unknown compression {comp} or filter "
                       f"method {filt}")
    mode, chans, _ = _PNG_TYPES[ctype]
    if mode == "P" and palette is None:
        raise PNGError(f"{name}: palette image without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{name}: corrupt image data ({e})") from None
    bits = chans * depth
    stride = (width * bits + 7) // 8
    rows = _unfilter(raw, height, stride, max(1, bits // 8), name)
    if depth < 8:                 # leftmost pixel in the high-order bits
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)
                ).reshape(height, -1)[:, :width]
    pixels = rows.reshape(height, width, chans)
    if mode == "P" and pixels.size and int(pixels.max()) >= len(palette):
        raise PNGError(f"{name}: palette index {int(pixels.max())} outside "
                       f"the {len(palette)}-entry palette")
    return pixels, mode, palette


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", binascii.crc32(ctype + body)))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → RGB PNG bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _rgb24(c: np.ndarray) -> np.ndarray:
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def quantize(rgb: np.ndarray, lut: np.ndarray = None
             ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(H, W, 3) uint8 → (indices (H·W,) uint8, palette (≤ 256, 3) uint8,
    bound): the frame's own colours when it has at most 256 (bound 0);
    otherwise the smallest shift s ≥ 1 at which the frame has at most 256
    distinct colours of `rgb >> s`, each mapped to its bin's centre, so
    every channel is within bound = 2**(s-1) of its value. `lut`, a
    2**24-entry uint8 scratch table, may be shared by consecutive calls."""
    if lut is None:
        lut = np.empty(1 << 24, np.uint8)
    code = _rgb24(rgb.reshape(-1, 3).astype(np.int32))
    colours = np.unique(code)
    chans = np.stack([colours >> 16, (colours >> 8) & 0xFF, colours & 0xFF],
                     axis=1)
    s, bins = 0, colours
    while len(bins) > 256:        # coarsen the distinct colours, not pixels
        s += 1
        bins = np.unique(_rgb24(chans >> s))
    lut[colours] = np.searchsorted(bins, _rgb24(chans >> s))
    pal = np.stack([bins >> 16, (bins >> 8) & 0xFF, bins & 0xFF], axis=1)
    if s:
        pal = (pal << s) + (1 << (s - 1))
    return lut[code], pal.astype(np.uint8), (1 << (s - 1)) if s else 0


_CLEAR, _EOI, _RUN = 256, 257, 254


def _lzw_literals(indices: np.ndarray) -> bytes:
    """GIF LZW image data (minimum code size 8) holding every index as a
    9-bit literal, a CLEAR before every _RUN of them and EOI last, packed
    least significant bit first into ≤ 255-byte sub-blocks."""
    n = len(indices)
    nclear = max(1, -(-n // _RUN))
    codes = np.empty(n + nclear + 1, np.uint16)
    is_clear = np.zeros(n + nclear, bool)
    is_clear[np.arange(nclear) * (_RUN + 1)] = True
    codes[:-1][is_clear] = _CLEAR
    codes[:-1][~is_clear] = indices
    codes[-1] = _EOI
    # 8 codes of 9 bits are 9 bytes: the low 64 bits as one little-endian
    # uint64, then the last code's top 8 bits
    nbytes = -(-len(codes) * 9 // 8)
    c = np.zeros(-(-len(codes) // 8) * 8, np.uint64)
    c[:len(codes)] = codes
    c = c.reshape(-1, 8)
    low = c[:, 0].copy()
    for k in range(1, 8):
        low |= c[:, k] << np.uint64(9 * k)
    data = np.concatenate([low.astype("<u8").view(np.uint8).reshape(-1, 8),
                           (c[:, 7] >> np.uint64(1)).astype(np.uint8)[:, None]],
                          axis=1).reshape(-1)[:nbytes]
    full = len(data) // 255
    blocks = np.concatenate([np.full((full, 1), 255, np.uint8),
                             data[:full * 255].reshape(full, 255)], axis=1)
    rest = data[full * 255:]
    tail = (bytes([len(rest)]) + rest.tobytes()) if len(rest) else b""
    return bytes([8]) + blocks.tobytes() + tail + b"\x00"


def encode_gif(frames: Sequence[np.ndarray], duration: float = 0.25,
               loop: int = 0) -> bytes:
    """(H, W, 3) uint8 frames, all one size → GIF89a bytes that loop `loop`
    times (0: forever), each frame shown `duration` seconds with its own
    palette (`quantize`)."""
    if not frames:
        raise ValueError("encode_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    delay = int(round(duration * 100))
    out: List[bytes] = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
                        b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
                        + struct.pack("<H", loop) + b"\x00"]
    lut = np.empty(1 << 24, np.uint8)
    for f in frames:
        f = np.asarray(f, np.uint8)
        if f.shape != (h, w, 3):
            raise ValueError(f"GIF frames must all be {(h, w, 3)} uint8, got "
                             f"{f.shape}")
        idx, pal, _ = quantize(f, lut)
        table = np.zeros((256, 3), np.uint8)
        table[:len(pal)] = pal
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),
                table.tobytes(), _lzw_literals(idx)]
    out.append(b"\x3b")
    return b"".join(out)
