"""The msgpack subset of the `dvg_tpu` checkpoint format, without msgpack or
flax (neither is installed where the port runs).

A checkpoint is one msgpack map written by flax.serialization: maps, arrays,
str, bin, nil, bool, ints, float64, and numpy arrays as extension type 1
(ext 3 for numpy scalars) whose payload is itself msgpack: the array
`(shape, dtype name, C-order bytes)`. `unpackb` decodes exactly that subset
(arrays come back as read-only numpy arrays) and raises on anything else:
float32, other extension types such as flax's complex, flax's
chunked-array marker. `packb` encodes it the way
msgpack-python does with `use_bin_type=True` (the shortest header for each
value, float64 for floats, dict order kept), so re-encoding a decoded blob
gives the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_MARKER = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    pass


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, blob):
        self.buf = memoryview(blob)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MsgpackError(f"truncated msgpack: {n} bytes wanted at "
                               f"offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        tag = self.unpack(">B")
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.str(tag & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if tag in ints:
            return self.unpack(ints[tag])
        if tag == 0xCB:
            return self.unpack(">d")
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
                   0xDC: ">H", 0xDD: ">I",                  # array
                   0xDE: ">H", 0xDF: ">I",                  # map
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}      # ext
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if tag in fixext:
            return self.ext(fixext[tag])
        if tag not in lengths:
            raise MsgpackError(f"msgpack type 0x{tag:02x} at offset "
                               f"{self.pos - 1} is not part of the checkpoint "
                               "format")
        n = self.unpack(lengths[tag])
        if tag in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if tag in (0xC7, 0xC8, 0xC9):
            return self.ext(n)
        if tag in (0xD9, 0xDA, 0xDB):
            return self.str(n)
        if tag in (0xDC, 0xDD):
            return self.array(n)
        return self.map(n)

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if CHUNKED_MARKER in out:
            raise MsgpackError("flax chunked arrays (leaves over 1 GiB) are "
                               "not part of the checkpoint format read here")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise MsgpackError(f"msgpack extension type {code} is not part "
                               "of the checkpoint format (1: ndarray, 3: "
                               "numpy scalar)")
        arr = _ndarray_from(data)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray_from(data: memoryview) -> np.ndarray:
    inner = _Reader(data)
    parts = inner.value()
    if inner.pos != len(data) or not (
            isinstance(parts, list) and len(parts) == 3
            and isinstance(parts[0], list) and isinstance(parts[1], str)
            and isinstance(parts[2], bytes)):
        raise MsgpackError("malformed ndarray extension payload")
    shape, name, raw = parts
    if name == "bfloat16":
        raise MsgpackError("bfloat16 arrays are not part of the checkpoint "
                           "format (dvg_tpu keeps parameters in float32)")
    dtype = np.dtype(name)
    if dtype.hasobject:
        raise MsgpackError(f"object dtype {name!r} in a checkpoint")
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def unpackb(blob) -> Any:
    reader = _Reader(blob)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise MsgpackError(f"{len(reader.buf) - reader.pos} trailing bytes "
                           "after the msgpack value")
    return out


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _header(out: list, n: int, fix: Tuple[int, int], tags: Tuple[int, ...],
            widths=(">B", ">H", ">I")) -> None:
    """fix = (base tag, largest fix length); tags = the 8/16/32-bit length
    tags, or fewer for types without an 8-bit form."""
    base, top = fix
    if base is not None and n <= top:
        out.append(struct.pack(">B", base | n))
        return
    widths = widths[len(widths) - len(tags):]
    for tag, fmt in zip(tags, widths):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(struct.pack(">B", tag) + struct.pack(fmt, n))
            return
    raise MsgpackError(f"length {n} is too large for msgpack")


def _int(out: list, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
             (0, 0xFFFFFFFF, 0xCE, ">I"), (0, (1 << 64) - 1, 0xCF, ">Q"),
             (-0x80, -1, 0xD0, ">b"), (-0x8000, -1, 0xD1, ">h"),
             (-0x80000000, -1, 0xD2, ">i"), (-(1 << 63), -1, 0xD3, ">q"))
    for lo, hi, tag, fmt in forms:
        if lo <= v <= hi:
            out.append(struct.pack(">B", tag) + struct.pack(fmt, v))
            return
    raise MsgpackError(f"integer {v} is out of msgpack's range")


def _bytes_of(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError(f"dtype {arr.dtype} cannot be written")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: list, v: Any) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, np.ndarray):
        _ext(out, EXT_NDARRAY, _bytes_of(v))
    elif isinstance(v, np.generic):
        _ext(out, EXT_NPSCALAR, _bytes_of(np.asarray(v)))
    elif type(v) is int:
        _int(out, v)
    elif type(v) is float:
        out.append(struct.pack(">Bd", 0xCB, v))
    elif type(v) is str:
        raw = v.encode("utf-8")
        _header(out, len(raw), (0xA0, 0x1F), (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif type(v) is bytes:
        _header(out, len(v), (None, -1), (0xC4, 0xC5, 0xC6))
        out.append(v)
    elif type(v) is list:
        _header(out, len(v), (0x90, 0x0F), (0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif type(v) is dict:
        _header(out, len(v), (0x80, 0x0F), (0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    else:
        raise MsgpackError(f"{type(v).__name__} is not part of the "
                           "checkpoint format")


def _ext(out: list, code: int, data: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(struct.pack(">B", fixext[len(data)]))
    else:
        _header(out, len(data), (None, -1), (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code))
    out.append(data)


def packb(value: Any) -> bytes:
    out: list = []
    _pack(out, value)
    return b"".join(out)
