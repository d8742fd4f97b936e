"""Offline dataset conversion (counterpart of `dvg_tpu/data/convert.py`:
the same functions, layouts and file names), with neither TensorFlow nor
PIL:

  * `convert_bair`    — softmotion30_44k TFRecords → PNG tree
    processed_data/{split}/traj_<shard>/<record>/<t>.png; a pure-Python
    TFRecord/Example parser reads the raw `{t}/image_aux1/encoded` 64×64×3
    RGB bytes of each record's 30 frames (reference data/convert_bair.py:
    20-66 used TF1 sessions). The PNGs are written by the port's own
    encoder (`utils/_codecs.encode_png`), so the files differ from
    `dvg_tpu`'s PIL-written ones byte for byte but not pixel for pixel.
  * `convert_videos`  — KTH/UCF .avi/.mp4/.mov → frame PNGs at 25 fps
    through an ffmpeg subprocess, into processed/<class>/<video>/
    image-%d_WxW.png (reference data/convert_kth.lua:17-27,
    convert_ucf.lua:17-26).
  * `build_metadata`  — walks processed/, splits each video's frames into
    4 chunks (`np.array_split`), writes {split}_meta<W>x<W>.json records
    {vid, files, n} that `data/frames.py` reads (reference
    data/meta_creator.py:5-23 wrote torch pickles of the same schema).

    python -c "from dvg_tpu_torch.data.convert import convert_bair; \\
        convert_bair('softmotion30_44k', 'data/bair', 'test')"
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dvg_tpu_torch.utils._codecs import encode_png


# ---------------------------------------------------------------------------
# TFRecord + tf.train.Example parsing (no TensorFlow)
# ---------------------------------------------------------------------------

def iter_tfrecords(path: str) -> Iterator[bytes]:
    """Yield the raw records of a TFRecord file (length-prefixed framing;
    the CRCs are skipped, not verified; a truncated tail ends the
    stream)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)                       # length CRC
            data = f.read(length)
            if len(data) < length:
                return
            f.read(4)                       # data CRC
            yield data


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_example(record: bytes) -> Dict[str, List[bytes]]:
    """A protobuf walk of tf.train.Example → {feature name: values}.

    Example := features(field 1) -> Features := feature map(field 1) ->
    map entry {key(1): string, value(2): Feature} ->
    Feature := one of bytes_list(1)/float_list(2)/int64_list(3), each a
    message with repeated field 1."""
    feats: Dict[str, List[bytes]] = {}

    def walk_msg(buf: bytes, handler):
        pos = 0
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if wire == 2:
                ln, pos = _read_varint(buf, pos)
                handler(field, buf[pos:pos + ln])
                pos += ln
            elif wire == 0:
                val, pos = _read_varint(buf, pos)
                handler(field, val)
            elif wire == 5:
                handler(field, buf[pos:pos + 4])
                pos += 4
            elif wire == 1:
                handler(field, buf[pos:pos + 8])
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    def on_example(field, val):
        if field == 1:                       # Features
            walk_msg(val, on_features)

    def on_features(field, val):
        if field == 1:                       # map<string, Feature> entry
            entry = {"key": None, "val": None}

            def on_entry(f, v):
                if f == 1:
                    entry["key"] = v.decode("utf-8", "replace")
                elif f == 2:
                    entry["val"] = v

            walk_msg(val, on_entry)
            values: List[bytes] = []

            def on_feature(f, v):
                # f: 1=BytesList 2=FloatList 3=Int64List — all wrap field 1
                def on_list(ff, vv):
                    if ff == 1:
                        values.append(vv)

                walk_msg(v, on_list)

            walk_msg(entry["val"], on_feature)
            feats[entry["key"]] = values

    walk_msg(record, on_example)
    return feats


def convert_bair(data_dir: str, out_dir: str, split: str = "train",
                 image_size: int = 64, frames_per_example: int = 30) -> int:
    """<data_dir>/<split>/*tfrecord* →
    <out_dir>/processed_data/<split>/traj_<shard>/<record>/<t>.png.

    Each record holds `frames_per_example` features named
    `{t}/image_aux1/encoded` with raw image_size² × 3 RGB bytes (reference
    convert_bair.py:28-38). Returns the number of trajectories written."""
    src = os.path.join(data_dir, split)
    files = sorted(f for f in os.listdir(src) if "tfrecord" in f)
    traj_count = 0
    for shard_idx, fname in enumerate(files):
        for rec_idx, rec in enumerate(iter_tfrecords(os.path.join(src, fname))):
            feats = parse_example(rec)
            traj_dir = os.path.join(out_dir, "processed_data", split,
                                    f"traj_{shard_idx}", str(rec_idx))
            os.makedirs(traj_dir, exist_ok=True)
            for t in range(frames_per_example):
                key = f"{t}/image_aux1/encoded"
                if key not in feats:
                    break
                arr = np.frombuffer(feats[key][0], np.uint8).reshape(
                    image_size, image_size, 3)
                with open(os.path.join(traj_dir, f"{t}.png"), "wb") as f:
                    f.write(encode_png(arr))
            traj_count += 1
    return traj_count


# ---------------------------------------------------------------------------
# video → frames (an ffmpeg driver; the reference's Lua scripts)
# ---------------------------------------------------------------------------

def convert_videos(video_root: str, out_root: str, classes: Sequence[str],
                   image_size: int = 64, fps: int = 25,
                   ffmpeg: str = "ffmpeg") -> List[str]:
    """For each <video_root>/<class>/*.avi|mp4|mov, extract frames to
    <out_root>/processed/<class>/<video>/image-%d_WxW.png at `fps`
    (reference convert_kth.lua:17-27 layout). Returns the converted video
    dirs."""
    done = []
    for cls in classes:
        cdir = os.path.join(video_root, cls)
        if not os.path.isdir(cdir):
            continue
        for vid in sorted(os.listdir(cdir)):
            if not vid.lower().endswith((".avi", ".mp4", ".mov")):
                continue
            name = os.path.splitext(vid)[0]
            odir = os.path.join(out_root, "processed", cls, name)
            os.makedirs(odir, exist_ok=True)
            pattern = os.path.join(
                odir, f"image-%d_{image_size}x{image_size}.png")
            cmd = [ffmpeg, "-y", "-i", os.path.join(cdir, vid),
                   "-r", str(fps), "-f", "image2",
                   "-s", f"{image_size}x{image_size}", pattern]
            subprocess.run(cmd, check=True, capture_output=True)
            done.append(odir)
    return done


# ---------------------------------------------------------------------------
# metadata (the reference's data/meta_creator.py, as JSON)
# ---------------------------------------------------------------------------

def build_metadata(processed_root: str, classes: Sequence[str],
                   image_size: int = 64, split: str = "train",
                   n_chunks: int = 4,
                   train_fraction: Optional[float] = None) -> str:
    """Walk <processed_root>/processed/<class>/<video>/ and write
    <processed_root>/{split}_meta<W>x<W>.json mapping class → list of
    {vid, files: [n_chunks lists of frame filenames], n} (the schema
    `data/frames.py` reads; reference meta_creator.py:5-23). Returns the
    file written."""
    meta: Dict[str, List[Dict]] = {}
    base = os.path.join(processed_root, "processed")
    for cls in classes:
        records = []
        cdir = os.path.join(base, cls)
        if not os.path.isdir(cdir):
            meta[cls] = []
            continue
        vids = sorted(os.listdir(cdir))
        if train_fraction is not None:
            cut = int(len(vids) * train_fraction)
            vids = vids[:cut] if split == "train" else vids[cut:]
        for vid in vids:
            vdir = os.path.join(cdir, vid)
            if not os.path.isdir(vdir):
                continue
            frames = sorted(os.listdir(vdir), key=_frame_key)
            # two convert_videos runs at two sizes share a video's dir
            # (image-%d_64x64.png and image-%d_128x128.png): where the
            # size-suffixed names are present keep this size's only, else
            # one sequence would interleave both
            sized = [f for f in frames
                     if f.endswith(f"_{image_size}x{image_size}.png")]
            if sized:
                frames = sized
            if not frames:
                continue
            # np.array_split, as the reference (meta_creator.py:20): every
            # frame lands in one chunk (103 frames split 26/26/26/25)
            chunks = [[str(f) for f in c]
                      for c in np.array_split(frames, n_chunks) if len(c)]
            records.append({"vid": vid, "files": chunks, "n": len(frames)})
        meta[cls] = records
    path = os.path.join(processed_root,
                        f"{split}_meta{image_size}x{image_size}.json")
    with open(path, "w") as f:
        json.dump(meta, f)
    return path


def _frame_key(name: str):
    digits = "".join(ch for ch in name if ch.isdigit())
    return (int(digits) if digits else 0, name)
