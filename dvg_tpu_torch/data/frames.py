"""PNG-tree video datasets: BAIR robot-push, KTH actions, UCF-101 subset
(counterpart of `dvg_tpu/data/frames.py`, the same layouts, draws and
refusals), decoded without PIL.

  * BAIR: frames at `<root>/processed_data/{train,test}/<shard>/<traj>/
    <t>.png` (64×64 RGB); training draws a random trajectory per item, test
    cycles the trajectory list; `len() == 10000` whatever is on disk.
  * KTH (6 classes, gray) and UCF (9 classes, RGB): per-class metadata
    `processed/<class>/<split>_meta<W>x<W>.{json,pt}` (lists of {"vid",
    "files": [chunks of frame names], "n"}) or one `<split>_meta<W>x<W>.
    {json,pt}` dict of classes; a random (class, video, chunk) draw is
    redrawn while the chunk is shorter than seq_len, then a random start;
    items are (seq, class_id). UCF falls back to the train split's metadata
    when the test split has none.

`_read_png` gives what Pillow's `Image.open(path).convert("L"|"RGB")` and
`resize((W, W), BILINEAR)` give, exactly: the port's PNG decoder
(`utils/_codecs.py`), Pillow's integer gray law and its resample
(`moving_mnist.resize_u8`). All datasets return float32 (T, H, W, C) in
[0, 1].
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dvg_tpu_torch.data.moving_mnist import resize_u8
from dvg_tpu_torch.utils._codecs import decode_png

KTH_CLASSES = ("boxing", "handclapping", "handwaving", "jogging",
               "running", "walking")
# the reference's 9-class UCF-101 subset and target ids
UCF_CLASSES = ("BenchPress", "BodyWeightSquats", "CleanAndJerk", "PullUps",
               "PushUps", "Shotput", "TennisSwing", "Lunges", "Fencing")


def _to_rgb(px: np.ndarray, mode: str, palette) -> np.ndarray:
    """Pillow's convert("RGB"): alpha dropped, gray replicated, the
    palette expanded."""
    if mode == "P":
        return palette[px[..., 0]]
    if mode in ("L", "LA"):
        return np.repeat(px[..., :1], 3, axis=-1)
    return px[..., :3]


def _to_l(px: np.ndarray, mode: str, palette) -> np.ndarray:
    """Pillow's convert("L"): (19595 R + 38470 G + 7471 B + 0x8000) >> 16
    of the RGB (or palette) colour, the gray channel of L and LA."""
    if mode in ("L", "LA"):
        return px[..., 0]
    rgb = _to_rgb(px, mode, palette).astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
             + 0x8000) >> 16).astype(np.uint8)


def _read_png(path: str, width: int, gray: bool) -> np.ndarray:
    """One frame → (W, W, C) float32 in [0, 1], C = 1 if gray else 3."""
    with open(path, "rb") as f:
        px, mode, palette = decode_png(f.read(), path)
    img = _to_l(px, mode, palette)[..., None] if gray else \
        _to_rgb(px, mode, palette)
    if img.shape[:2] != (width, width):
        img = resize_u8(img[None], width, width)[0]
    return img.astype(np.float32) / 255.0


def _read_sequence(paths, width: int, gray: bool) -> np.ndarray:
    """A frame sequence → (T, W, W, C) float32 in [0, 1]."""
    return np.stack([_read_png(p, width, gray) for p in paths])


class BAIR:
    """BAIR robot-push 64x64 RGB, 30-frame trajectories."""

    # every integer index is a valid fresh (seed, index) draw, so the
    # Loader widens its shuffle domain past len()
    INDEX_PURE = True

    def __init__(self, train: bool = True, data_root: str = ".",
                 seq_len: int = 30, image_size: int = 64, seed: int = 1):
        self.root = os.path.join(
            data_root, "processed_data", "train" if train else "test")
        self.train = train
        self.seq_len = seq_len
        self.image_size = image_size
        self.seed = (seed, 0 if train else 1)
        self.dirs: List[str] = []
        if os.path.isdir(self.root):
            for shard in sorted(os.listdir(self.root)):
                sp = os.path.join(self.root, shard)
                if not os.path.isdir(sp):
                    continue
                for traj in sorted(os.listdir(sp), key=_numeric_key):
                    tp = os.path.join(sp, traj)
                    if os.path.isdir(tp):
                        self.dirs.append(tp)

    def __len__(self) -> int:
        return 10000  # the reference hardcodes the epoch length

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        if not self.dirs:
            raise FileNotFoundError(
                f"no BAIR trajectories under {self.root}; run "
                "data/download_bair.sh + dvg_tpu.data.convert.convert_bair")
        if self.train:
            rng = np.random.default_rng((*self.seed, index))
            d = self.dirs[int(rng.integers(0, len(self.dirs)))]
        else:
            d = self.dirs[index % len(self.dirs)]
        paths = [os.path.join(d, f"{t}.png") for t in range(self.seq_len)]
        return _read_sequence(paths, self.image_size, gray=False), 0


class _MetaVideoDataset:
    """Random-window loader over the chunked frame-list metadata shared by
    KTH and UCF."""

    classes: Sequence[str] = ()
    gray: bool = False
    INDEX_PURE = True        # see BAIR.INDEX_PURE

    def __init__(self, train: bool = True, data_root: str = ".",
                 seq_len: int = 20, image_size: int = 64, seed: int = 1):
        self.root = data_root
        self.train = train
        self.seq_len = seq_len
        self.image_size = image_size
        self.seed = (seed, 0 if train else 1)
        self.meta = self._load_meta(train)
        self._validate_meta()

    def _meta_path(self, train: bool, ext: str) -> str:
        split = "train" if train else "test"
        w = self.image_size
        return os.path.join(self.root, f"{split}_meta{w}x{w}.{ext}")

    def _load_meta(self, train: bool) -> Optional[dict]:
        # the reference's layout first: one metadata file per class
        split = "train" if train else "test"
        w = self.image_size
        paths = {}
        for c in self.classes:
            for ext in ("json", "pt"):
                p = os.path.join(self.root, "processed", c,
                                 f"{split}_meta{w}x{w}.{ext}")
                if os.path.exists(p):
                    paths.setdefault(c, p)
        if paths:
            # a partial set would silently narrow the sampled classes
            missing = [c for c in self.classes if c not in paths]
            if missing:
                raise FileNotFoundError(
                    f"per-class metadata present for {sorted(paths)} but "
                    f"missing for {missing} (expected e.g. processed/"
                    f"{missing[0]}/{split}_meta{w}x{w}.json); convert all "
                    "classes or remove the partial layout")
            return {c: self._read_meta_file(p) for c, p in paths.items()}
        jpath = self._meta_path(train, "json")
        if os.path.exists(jpath):
            with open(jpath) as f:
                return json.load(f)
        ppath = self._meta_path(train, "pt")
        if os.path.exists(ppath):
            raw = self._read_meta_file(ppath)
            return {c: raw[c] for c in raw}
        return None

    @staticmethod
    def _read_meta_file(path: str):
        if path.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        # the reference's torch-pickled metadata (lists of numpy string
        # arrays), which weights_only=True rejects: the user's own file,
        # the trust the reference extends to it
        import torch
        return torch.load(path, weights_only=False)

    def _validate_meta(self) -> None:
        """Class coverage, checked once at load; missing metadata (None)
        stays legal until an item is asked for."""
        if self.meta is None:
            return
        avail = [c for c in self.classes if self.meta.get(c)]
        if not avail:
            raise ValueError(
                f"metadata classes {sorted(self.meta)} share no names with "
                f"the expected {type(self).__name__} classes "
                f"{list(self.classes)} (or all record lists are empty) — "
                "check class naming/casing in the metadata file")
        if len(avail) != len(self.classes):
            bad = [c for c in self.classes if not self.meta.get(c)]
            raise ValueError(
                f"metadata has records for {avail} but none for {bad} — "
                "convert every class or restrict the dataset's `classes`")

    def __len__(self) -> int:
        return len(self.classes) * 100 if self.train else 1000

    def _frame_dir(self, cls: str, vid: str) -> str:
        return os.path.join(self.root, "processed", cls, vid)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        if self.meta is None:
            raise FileNotFoundError(
                f"metadata not found at {self._meta_path(self.train, 'json')}; "
                "run dvg_tpu.data.convert.build_metadata after frame conversion")
        rng = np.random.default_rng((*self.seed, index))
        avail = self.classes
        # redraw (class, video, chunk) while the chunk is shorter than
        # seq_len; after 1000 draws right-pad the last one
        for _ in range(1000):
            cls = avail[int(rng.integers(0, len(avail)))]
            vids = self.meta[cls]
            rec = vids[int(rng.integers(0, len(vids)))]
            if not rec.get("files"):
                raise ValueError(
                    f"metadata record {rec.get('vid')!r} in class {cls!r} "
                    "has an empty 'files' list — rebuild the metadata for "
                    "that video (dvg_tpu.data.convert.build_metadata)")
            chunk = rec["files"][int(rng.integers(0, len(rec["files"])))]
            if len(chunk) >= self.seq_len:
                break
        cls_id = self.classes.index(cls)
        # len(), not truthiness: .pt chunks are numpy string arrays
        if len(chunk) == 0:
            raise ValueError(
                f"metadata record {rec.get('vid')!r} in class {cls!r} "
                "contains an empty frame chunk — rebuild the metadata for "
                "that video (dvg_tpu.data.convert.build_metadata)")
        if len(chunk) < self.seq_len:
            start = 0
            chunk = list(chunk) + [chunk[-1]] * (self.seq_len - len(chunk))
        else:
            start = int(rng.integers(0, len(chunk) - self.seq_len + 1))
        d = self._frame_dir(cls, rec["vid"])
        paths = [os.path.join(d, fn)
                 for fn in chunk[start:start + self.seq_len]]
        return _read_sequence(paths, self.image_size, self.gray), cls_id


class KTH(_MetaVideoDataset):
    classes = KTH_CLASSES
    gray = True


class UCF(_MetaVideoDataset):
    classes = UCF_CLASSES
    gray = False

    def __init__(self, train: bool = True, **kw):
        super().__init__(train=train, **kw)
        if self.meta is None and train is False:
            # the reference forces the train split; fall back likewise
            self.meta = self._load_meta(True)
            self.train = True
            self._validate_meta()


def _numeric_key(name: str):
    return (0, int(name)) if name.isdigit() else (1, name)
