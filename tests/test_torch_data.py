"""The port's data modules against `dvg_tpu.data` on the same inputs: the
Moving-MNIST datasets bit-equal (procedural glyphs and a tiny idx file,
train and test splits), the device-assembled batch exact at two digits,
the PIL-free bilinear resize equal to Pillow's, PNG frames decoded equal
to the PIL path (gray, gray+alpha, RGB, RGBA, palette, every row filter, a
resize), the BAIR/KTH/UCF items equal to `dvg_tpu`'s through both
packages' PIL-law paths and through both native decoders as built
(`DECODER_ATOL`), the Loader's batches equal for the same (seed, step),
and the same refusals."""

import gzip
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from dvg_tpu.data import Loader as JLoader
from dvg_tpu.data import frames as jframes
from dvg_tpu.data import moving_mnist as jmm
from dvg_tpu_torch.data import Loader, frames, moving_mnist as mm
from dvg_tpu_torch.utils._codecs import PNGError, decode_png


def write_idx(root, train, n=12, gz=False):
    stem = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    imgs = np.random.RandomState(3 + train).randint(0, 256, (n, 28, 28))
    blob = struct.pack(">IIII", 2051, n, 28, 28) + imgs.astype(
        np.uint8).tobytes()
    path = os.path.join(root, stem + (".gz" if gz else ""))
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(blob)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("digits", ["procedural", "idx"])
def test_moving_mnist_bit_equal(tmp_path, train, digits):
    root = ""
    if digits == "idx":
        root = str(tmp_path)
        write_idx(root, True)
        write_idx(root, False, gz=True)
    kw = dict(train=train, data_root=root, seq_len=9, seed=5)
    ref, port = jmm.MovingMNIST(**kw), mm.MovingMNIST(**kw)
    np.testing.assert_array_equal(port.digits, ref.digits)
    for i in (0, 7):
        np.testing.assert_array_equal(port[i][0], ref[i][0])
    np.testing.assert_array_equal(port.sample_batch(3, 6),
                                  ref.sample_batch(3, 6))
    for a, b in zip(port.batch_parts(3, 6), ref.batch_parts(3, 6)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_device_batch_matches_dvg_tpu():
    kw = dict(train=False, seq_len=12, num_digits=2, seed=2)
    ref = np.asarray(jmm.MovingMNIST(**kw).device_batch(5, 10))
    port = mm.MovingMNIST(**kw)
    got = port.device_batch(5, 10, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (12, 5, 64, 64, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), port.sample_batch(5, 10))


@pytest.mark.parametrize("size,out", [(28, 32), (64, 48)],
                         ids=["up", "down"])
def test_resize_equals_pillow(size, out):
    u8 = np.random.RandomState(size).randint(0, 256, (3, size, size)
                                             ).astype(np.uint8)
    got = mm.resize_u8(u8, out, out)
    for i in range(3):
        want = np.asarray(Image.fromarray(u8[i]).resize((out, out),
                                                        Image.BILINEAR))
        np.testing.assert_array_equal(got[i], want)
    rgb = np.random.RandomState(1).randint(0, 256, (size, size + 9, 3)
                                           ).astype(np.uint8)
    np.testing.assert_array_equal(
        mm.resize_u8(rgb[None], out, out + 3)[0],
        np.asarray(Image.fromarray(rgb).resize((out + 3, out),
                                               Image.BILINEAR)))
    f = u8.astype(np.float32) / 255.0
    np.testing.assert_array_equal(mm._resize_bilinear(f, out),
                                  jmm._resize_bilinear(f, out))


def smooth(rng, h, w, c):
    return np.clip(np.cumsum(rng.normal(size=(h, w, c)), axis=0) * 20 + 128,
                   0, 255).astype(np.uint8)


def pil_frame(rng, kind, size):
    """A PIL image of the given kind: gray, gray+alpha, RGB, RGBA or a
    palette image at 4 or 8 bits."""
    rgb = smooth(rng, size, size, 3)
    if kind == "L":
        return Image.fromarray(rgb[..., 0])
    if kind == "LA":
        return Image.fromarray(np.dstack([rgb[..., 0], rgb[..., 1]]), "LA")
    if kind == "RGBA":
        return Image.fromarray(np.dstack([rgb, rgb[..., :1]]), "RGBA")
    if kind == "P4":
        return Image.fromarray(rgb).quantize(16)
    if kind == "P8":
        return Image.fromarray(rgb).quantize(200)
    return Image.fromarray(rgb)


KINDS = ("RGB", "L", "LA", "RGBA", "P4", "P8")


def test_png_decode_matches_pil_for_every_mode():
    rng = np.random.default_rng(0)
    for kind in KINDS:
        im = pil_frame(rng, kind, 13)
        buf = io.BytesIO()
        im.save(buf, "PNG")
        px, mode, pal = decode_png(buf.getvalue(), kind)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
        got = px[..., 0] if px.shape[-1] == 1 else px
        np.testing.assert_array_equal(got, want, err_msg=kind)


def png_chunk(t, b):
    return struct.pack(">I", len(b)) + t + b + struct.pack(
        ">I", zlib.crc32(t + b))


def png_with_filters(img, depth=8, interlace=0):
    """An RGB PNG whose rows cycle through all five filter types."""
    h, w, _ = img.shape
    a = img.astype(np.int64).reshape(h, -1)
    out = []
    for y in range(h):
        ftype, x = y % 5, a[y]
        up = a[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(3, np.int64), x[:-3]])
        ul = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        if ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - up
        elif ftype == 3:
            f = x - (left + up) // 2
        elif ftype == 4:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            f = x - np.where((pa <= pb) & (pa <= pc), left,
                             np.where(pb <= pc, up, ul))
        else:
            f = x
        out.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n"
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0,
                                             0, interlace))
            + png_chunk(b"IDAT", zlib.compress(b"".join(out)))
            + png_chunk(b"IEND", b""))


def test_png_every_row_filter_and_refusals():
    img = smooth(np.random.default_rng(1), 11, 9, 3)
    data = png_with_filters(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(decode_png(data, "f")[0], img)
    for kw in (dict(depth=16), dict(interlace=1)):
        with pytest.raises(PNGError, match="frame_x.png"):
            decode_png(png_with_filters(img, **kw), "frame_x.png")
    with pytest.raises(PNGError, match="CRC"):
        decode_png(data[:40] + bytes([data[40] ^ 1]) + data[41:], "bad.png")


def bair_tree(root, rng):
    for v in range(3):
        d = os.path.join(root, "processed_data", "test", "s0", str(v))
        os.makedirs(d)
        for t in range(6):
            kind = KINDS[(v + t) % len(KINDS)]
            size = 80 if t == 2 else 64          # frame 2 forces a resize
            pil_frame(rng, kind, size).save(os.path.join(d, f"{t}.png"))


def meta_tree(root, classes, rng):
    meta = {}
    for ci, cls in enumerate(classes):
        d = os.path.join(root, "processed", cls, "v0")
        os.makedirs(d)
        files = []
        for t in range(8):
            name = f"image-{t}_64x64.png"
            kind = KINDS[(ci + t) % len(KINDS)]
            pil_frame(rng, kind, 72 if t == 3 else 64).save(
                os.path.join(d, name))
            files.append(name)
        meta[cls] = [{"vid": "v0", "files": [files[:4], files[4:]], "n": 8}]
    with open(os.path.join(root, "train_meta64x64.json"), "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_read_png_equals_pil_path(tmp_path, gray):
    rng = np.random.default_rng(2)
    bair_tree(str(tmp_path), rng)
    paths = sorted(str(p) for p in tmp_path.rglob("*.png"))
    assert len(paths) == 18
    for p in paths:
        np.testing.assert_array_equal(frames._read_png(p, 64, gray),
                                      jframes._read_png(p, 64, gray),
                                      err_msg=p)


@pytest.fixture
def pil_path(monkeypatch):
    """dvg_tpu's frame datasets decode through PIL, not its native
    decoder, and the port's through its numpy decoder, not its copy of
    that native decoder."""
    from dvg_tpu.runtime import fastload
    from dvg_tpu_torch.runtime import fastload as port_fastload
    monkeypatch.setattr(fastload, "is_available", lambda: False)
    monkeypatch.setattr(port_fastload, "is_available", lambda: False)


# Each package decodes with its native libpng decoder when that is built,
# else by the PIL law (dvg_tpu through PIL, the port in numpy). The two
# native decoders are one source, and the two PIL-law paths agree exactly,
# so either way the port gives dvg_tpu's frames exactly.
DECODER_ATOL = {"pil": 0.0, "as_built": 0.0}


@pytest.mark.parametrize("decoder", ["pil", "as_built"])
def test_frame_datasets_match_dvg_tpu(tmp_path, request, decoder):
    if decoder == "pil":
        request.getfixturevalue("pil_path")
    else:
        from dvg_tpu.runtime import fastload
        from dvg_tpu_torch.runtime import fastload as port_fastload
        assert port_fastload.is_available() == fastload.is_available(), \
            port_fastload.status()
    atol = DECODER_ATOL[decoder]
    rng = np.random.default_rng(4)
    bair_tree(str(tmp_path / "bair"), rng)
    ref = jframes.BAIR(train=False, data_root=str(tmp_path / "bair"),
                       seq_len=6)
    port = frames.BAIR(train=False, data_root=str(tmp_path / "bair"),
                       seq_len=6)
    assert port.dirs == ref.dirs and len(port) == len(ref)
    for i in range(3):
        np.testing.assert_allclose(port[i][0], ref[i][0], atol=atol)
    for name, classes in (("KTH", jframes.KTH_CLASSES),
                          ("UCF", jframes.UCF_CLASSES)):
        root = str(tmp_path / name)
        meta_tree(root, classes, rng)
        ref = getattr(jframes, name)(train=True, data_root=root, seq_len=5)
        port = getattr(frames, name)(train=True, data_root=root, seq_len=5)
        for i in (0, 3, 11):
            (a, ca), (b, cb) = port[i], ref[i]
            assert ca == cb and a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=atol)


@pytest.mark.parametrize("shuffle", [False, True],
                         ids=["in_order", "shuffled"])
def test_loader_batches_match_dvg_tpu(tmp_path, shuffle):
    root = str(tmp_path)
    meta_tree(root, jframes.KTH_CLASSES, np.random.default_rng(5))
    kw = dict(train=True, data_root=root, seq_len=4)
    ref = JLoader(jframes.KTH(**kw), 3, shuffle=shuffle, seed=7,
                  num_threads=2)
    port = Loader(frames.KTH(**kw), 3, shuffle=shuffle, seed=7,
                  num_threads=2)
    for step in (0, 5):
        np.testing.assert_array_equal(port._indices(step),
                                      ref._indices(step))
        np.testing.assert_array_equal(port.next_batch(step),
                                      ref.next_batch(step))
    it = port.iter_from(5)
    np.testing.assert_array_equal(next(it), port.next_batch(5))
    port.stop()
    ref.stop()
    # the synthetic set: host batches, and device batches on the CPU
    kw = dict(train=False, seq_len=5, seed=3)
    want = np.asarray(JLoader(jmm.MovingMNIST(**kw), 4, shuffle=shuffle,
                              seed=1).next_batch(2))
    got = Loader(mm.MovingMNIST(**kw), 4, shuffle=shuffle, seed=1)
    np.testing.assert_array_equal(got.next_batch(2), want)
    dev = Loader(mm.MovingMNIST(**kw), 4, shuffle=shuffle, seed=1,
                 device="cpu").next_batch(2)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), want)


def test_refusals_match_dvg_tpu(tmp_path):
    # a corrupt idx file is fatal
    corrupt = tmp_path / "corrupt"
    corrupt.mkdir()
    (corrupt / "t10k-images-idx3-ubyte").write_bytes(b"\x00" * 20)
    for mod in (jmm, mm):
        with pytest.raises(ValueError, match="unreadable"):
            mod.MovingMNIST(train=False, data_root=str(corrupt))
    # the other split present, this one missing
    half = tmp_path / "half"
    half.mkdir()
    write_idx(str(half), True)
    for mod in (jmm, mm):
        with pytest.raises(FileNotFoundError, match="OTHER split"):
            mod.MovingMNIST(train=False, data_root=str(half))
    # per-class metadata for some classes only
    cdir = tmp_path / "partial" / "processed" / "walking"
    cdir.mkdir(parents=True)
    (cdir / "train_meta64x64.json").write_text(
        json.dumps([{"vid": "v", "files": [["0.png"]], "n": 1}]))
    # single-file metadata with an empty class
    single = tmp_path / "single"
    single.mkdir()
    meta = {c: [{"vid": "v", "files": [["0.png"] * 9], "n": 9}]
            for c in jframes.KTH_CLASSES[:5]}
    meta[jframes.KTH_CLASSES[5]] = []
    (single / "train_meta64x64.json").write_text(json.dumps(meta))
    for mod in (jframes, frames):
        with pytest.raises(FileNotFoundError, match="missing for"):
            mod.KTH(train=True, data_root=str(tmp_path / "partial"),
                    seq_len=5)
        with pytest.raises(ValueError, match="none for"):
            mod.KTH(train=True, data_root=str(single), seq_len=5)
