"""The port's dataset converters and native frame decoder against
`dvg_tpu`'s, on data written inside the tests (nothing is downloaded):

  * `iter_tfrecords`/`parse_example` on synthetic TFRecords in the exact
    framing (every protobuf wire type, a truncated tail) give what
    `dvg_tpu`'s give;
  * `convert_bair` writes the same file list as `dvg_tpu`'s, every frame
    pixel-equal (the port writes its PNGs with its own encoder, `dvg_tpu`
    with PIL: the files may differ, the pixels may not);
  * `build_metadata` writes equal JSON, with the size-suffix filter, the
    np.array_split chunks and the train fraction;
  * `convert_videos` gives a stub ffmpeg the same argv as `dvg_tpu`'s and
    the same layout;
  * the native decoder, built here with g++, equals `dvg_tpu`'s native
    decoder bit for bit on PNG and JPEG, RGB and gray, resized and not; a
    missing file raises naming it.
Every comparison is exact (tolerance 0)."""

import json
import os
import stat
import struct

import numpy as np
import pytest
from PIL import Image

from dvg_tpu.data import convert as jconvert
from dvg_tpu.runtime import fastload as jfastload
from dvg_tpu_torch.data import convert
from dvg_tpu_torch.runtime import fastload


def varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def ld(field: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return varint((field << 3) | 2) + varint(len(payload)) + payload


def feature_entry(key: str, feature: bytes) -> bytes:
    return ld(1, ld(1, key.encode()) + ld(2, feature))


def example(frames, actions) -> bytes:
    """A tf.train.Example with softmotion30_44k's image features (a
    BytesList each), a packed FloatList, an unpacked Int64List (varints),
    an unpacked FloatList (fixed32) and an unknown fixed64 field."""
    entries = [feature_entry(f"{t}/image_aux1/encoded",
                             ld(1, ld(1, f.tobytes())))
               for t, f in enumerate(frames)]
    entries.append(feature_entry("0/action", ld(2, ld(
        1, np.asarray(actions, "<f4").tobytes()))))
    entries.append(feature_entry("0/step", ld(3, varint(1 << 3) + varint(300)
                                              + varint(1 << 3) + varint(7))))
    entries.append(feature_entry("0/gain", ld(2, varint((1 << 3) | 5)
                                              + struct.pack("<f", 0.5))))
    extra = varint((9 << 3) | 1) + struct.pack("<d", 1.25)
    return ld(1, b"".join(entries)) + extra


def write_tfrecord(path, records, truncate: int = 0) -> None:
    """TFRecord framing: length (u64), its CRC, data, the data's CRC (the
    CRCs written as zeros: the readers skip them). `truncate` cuts that
    many bytes off the last record."""
    blob = b"".join(struct.pack("<Q", len(r)) + b"\0" * 4 + r + b"\0" * 4
                    for r in records)
    with open(path, "wb") as f:
        f.write(blob[:len(blob) - truncate])


def bair_records(tmp_path, n_files=2, per_file=3, frames=5, truncate=40):
    """<tmp>/raw/test/traj_<i>_to_<j>.tfrecords of procedural clips; the
    last file's last record is cut short."""
    rng = np.random.default_rng(0)
    src = tmp_path / "raw" / "test"
    src.mkdir(parents=True)
    for i in range(n_files):
        recs = [example([rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                         for _ in range(frames)], rng.normal(size=4))
                for _ in range(per_file)]
        write_tfrecord(src / f"traj_{i * 256}_to_{i * 256 + 255}.tfrecords",
                       recs, truncate if i == n_files - 1 else 0)
    (src / "README").write_text("not a record file")
    return str(tmp_path / "raw")


def test_tfrecords_parse_equal_dvg_tpu(tmp_path):
    raw = bair_records(tmp_path)
    for name in sorted(os.listdir(os.path.join(raw, "test"))):
        if "tfrecord" not in name:
            continue
        path = os.path.join(raw, "test", name)
        got = list(convert.iter_tfrecords(path))
        want = list(jconvert.iter_tfrecords(path))
        assert got == want and len(got) == (2 if name.startswith(
            "traj_256") else 3)
        for rec in got:
            feats = convert.parse_example(rec)
            assert feats == jconvert.parse_example(rec)
            assert feats["0/step"] == [300, 7]
            assert feats["0/gain"] == [struct.pack("<f", 0.5)]
            assert len(feats["4/image_aux1/encoded"][0]) == 64 * 64 * 3


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_convert_bair_pixel_equal_dvg_tpu(tmp_path):
    raw = bair_records(tmp_path)
    n = convert.convert_bair(raw, str(tmp_path / "port"), split="test",
                             frames_per_example=5)
    assert n == jconvert.convert_bair(raw, str(tmp_path / "jax"),
                                      split="test", frames_per_example=5)
    assert n == 5
    files = tree_files(tmp_path / "port")
    assert files == tree_files(tmp_path / "jax") and len(files) == 25
    for rel in files:
        a = np.asarray(Image.open(tmp_path / "port" / rel))
        b = np.asarray(Image.open(tmp_path / "jax" / rel))
        assert a.shape == (64, 64, 3)
        np.testing.assert_array_equal(a, b, err_msg=rel)


def video_tree(root):
    """processed/<class>/<video>/ frames: one video at two sizes (the
    size-suffix case), one of 13 frames (array_split 4/3/3/3), one
    without size suffixes, an empty dir and a stray file."""
    def frame(d, name):
        os.makedirs(d, exist_ok=True)
        Image.fromarray(np.zeros((8, 8), np.uint8)).save(os.path.join(d, name))
    base = os.path.join(root, "processed")
    for t in range(10):
        frame(os.path.join(base, "boxing", "v0"), f"image-{t}_64x64.png")
        frame(os.path.join(base, "boxing", "v0"), f"image-{t}_128x128.png")
    for t in range(13):
        frame(os.path.join(base, "boxing", "v1"), f"image-{t}_64x64.png")
    for t in range(6):
        frame(os.path.join(base, "walking", "v2"), f"{t}.png")
    os.makedirs(os.path.join(base, "walking", "empty"))
    with open(os.path.join(base, "walking", "notes.txt"), "w") as f:
        f.write("x")


@pytest.mark.parametrize("kw", [
    dict(image_size=64, split="train"),
    dict(image_size=128, split="test", n_chunks=3),
    dict(image_size=64, split="test", train_fraction=0.5),
], ids=["64", "128", "fraction"])
def test_build_metadata_equals_dvg_tpu(tmp_path, kw):
    video_tree(str(tmp_path))
    classes = ("boxing", "walking", "running")
    got = convert.build_metadata(str(tmp_path), classes, **kw)
    with open(got) as f:
        meta = json.load(f)
    os.rename(got, got + ".port")
    want = jconvert.build_metadata(str(tmp_path), classes, **kw)
    assert got == want
    with open(want) as f:
        assert meta == json.load(f)
    if kw == dict(image_size=64, split="train"):
        v0, v1 = meta["boxing"]
        assert v0["n"] == 10 and all("_64x64" in f for c in v0["files"]
                                     for f in c)
        assert [len(c) for c in v1["files"]] == [4, 3, 3, 3]
        assert meta["walking"][0]["n"] == 6 and meta["running"] == []


def stub_ffmpeg(path, log):
    """An ffmpeg that logs its argv as one JSON line and writes two frames
    at the output pattern."""
    path.write_text(
        "#!/usr/bin/env python3\n"
        "import json, sys\n"
        f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "for i in (1, 2):\n"
        "    open(sys.argv[-1] % i, 'wb').write(b'png')\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


def test_convert_videos_equals_dvg_tpu(tmp_path):
    videos = tmp_path / "videos"
    for cls, names in (("boxing", ("b1.avi", "b0.AVI", "skip.txt")),
                       ("walking", ("w0.mp4", "w1.mov"))):
        (videos / cls).mkdir(parents=True)
        for n in names:
            (videos / cls / n).write_bytes(b"")
    runs = {}
    for name, mod in (("port", convert), ("jax", jconvert)):
        ffmpeg, log = tmp_path / f"ffmpeg_{name}", tmp_path / f"{name}.log"
        stub_ffmpeg(ffmpeg, log)
        out = tmp_path / name
        done = mod.convert_videos(str(videos), str(out),
                                  ("boxing", "walking", "jogging"),
                                  image_size=128, ffmpeg=str(ffmpeg))
        argv = [json.loads(line) for line in log.read_text().splitlines()]
        runs[name] = ([os.path.relpath(d, out) for d in done],
                      [[a.replace(str(out), "OUT") for a in v] for v in argv],
                      tree_files(out))
    assert runs["port"] == runs["jax"]
    dirs, argv, files = runs["port"]
    assert dirs == ["processed/boxing/b0", "processed/boxing/b1",
                    "processed/walking/w0", "processed/walking/w1"]
    assert argv[0] == ["-y", "-i", str(videos / "boxing" / "b0.AVI"),
                       "-r", "25", "-f", "image2", "-s", "128x128",
                       "OUT/processed/boxing/b0/image-%d_128x128.png"]
    assert len(files) == 8


def decoder_frames(root):
    """PNG and JPEG frames, RGB and gray, at 64 px and at sizes that
    resize, plus a palette and an RGBA PNG."""
    rng = np.random.default_rng(3)
    paths = []
    for i, (size, mode, ext) in enumerate([
            (64, "RGB", "png"), (64, "L", "png"), (80, "RGB", "png"),
            (48, "L", "png"), (64, "RGB", "jpg"), (64, "L", "jpeg"),
            (96, "RGB", "jpg"), (40, "L", "jpg"), (64, "P", "png"),
            (72, "RGBA", "png")]):
        rgb = np.clip(np.cumsum(rng.normal(size=(size, size, 3)), axis=0)
                      * 20 + 128, 0, 255).astype(np.uint8)
        img = Image.fromarray(rgb)
        img = img.quantize(64) if mode == "P" else img.convert(mode)
        path = os.path.join(root, f"f{i}.{ext}")
        img.save(path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("channels", [3, 1], ids=["rgb", "gray"])
def test_native_decoder_bit_equal_dvg_tpu(tmp_path, channels):
    assert fastload.is_available(), fastload.status()
    assert jfastload.is_available()
    paths = decoder_frames(str(tmp_path))
    got = fastload.decode_batch(paths, 64, 64, channels, n_threads=3)
    want = jfastload.decode_batch(paths, 64, 64, channels, n_threads=3)
    assert got.shape == (len(paths), 64, 64, channels)
    np.testing.assert_array_equal(got, want)
    buf = np.empty((2, 5, 64, 64, channels), np.float32)
    fastload.decode_batch(paths, 64, 64, channels, out=buf)
    np.testing.assert_array_equal(buf.reshape(got.shape), got)
    missing = str(tmp_path / "gone.png")
    with pytest.raises(IOError, match="gone.png"):
        fastload.decode_batch(paths[:2] + [missing], 64, 64, channels)
