"""Host data pipeline: the dataset registry and a threaded batch loader
(counterpart of `dvg_tpu/data/pipeline.py`).

Batches are time-major (T, B, H, W, C) float32, built on the host and sent
to the run's device in one copy, or — for Moving-MNIST — assembled on the
device from a few KB of trajectories (`MovingMNIST.device_batch`). Item
decoding runs on a persistent thread pool and whole batches are built ahead
of the consumer.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from concurrent.futures import CancelledError, ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.data.frames import BAIR, KTH, UCF
from dvg_tpu_torch.data.moving_mnist import MovingMNIST


def load_dataset(cfg: DVGConfig, seq_len: Optional[int] = None,
                 split: str = "both"):
    """The dataset registry → (train, test), or one of them for
    split="train"/"test". seq_len defaults to max(n_past + n_future,
    n_eval)."""
    T = seq_len if seq_len is not None else max(
        cfg.n_past + cfg.n_future, cfg.n_eval)
    name = cfg.dataset.lower()
    if name in ("smmnist", "mnist", "moving_mnist"):
        mk = lambda train: MovingMNIST(
            train=train, data_root=cfg.data_root, seq_len=T,
            num_digits=cfg.num_digits, image_size=cfg.image_width,
            seed=cfg.seed)
    elif name == "bair":
        mk = lambda train: BAIR(train=train, data_root=cfg.data_root,
                                seq_len=T, image_size=cfg.image_width,
                                seed=cfg.seed)
    elif name == "kth":
        mk = lambda train: KTH(train=train, data_root=cfg.data_root,
                               seq_len=T, image_size=cfg.image_width,
                               seed=cfg.seed)
    elif name == "ucf":
        mk = lambda train: UCF(train=train, data_root=cfg.data_root,
                               seq_len=T, image_size=cfg.image_width,
                               seed=cfg.seed)
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    if split == "train":
        return mk(True)
    if split == "test":
        return mk(False)
    if split != "both":
        raise ValueError(f"split must be train|test|both, got {split!r}")
    return mk(True), mk(False)


def normalize_batch(items) -> np.ndarray:
    """A list of (T, H, W, C) sequences → time-major (T, B, H, W, C)."""
    return np.stack(items, axis=1).astype(np.float32)


class Loader:
    """Threaded, prefetching batch loader.

    `next_batch(step)` and the endless `iter_from(step)` give step's
    time-major batch: a numpy array when `device` is None, else a tensor on
    `device` (assembled there by the dataset's `device_batch` where it has
    one, else one host-to-device copy). Step's items are a pure
    function of (seed, step): `_indices`. `num_threads` decode workers fan
    out over the items of a batch and up to `prefetch` batches are built
    ahead, both on persistent pools that `stop()` or the loader's garbage
    collection shuts down.

    Data parallel (`world` > 1): `batch_size` is the global batch and the
    loader gives rank `rank` its rows [rank·B/world, (rank+1)·B/world), as
    `dvg_tpu`'s Loader gives each process its block. Every rank draws the
    same global index list and keeps its slice; a synthetic dataset, whose
    stream depends on the batch size, builds the whole global batch and
    slices it, so the ranks together see what one process would."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, num_threads: int = 4, prefetch: int = 4,
                 device=None, rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} does not divide "
                             f"over {world} ranks")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = slice(rank * batch_size // world,
                          (rank + 1) * batch_size // world)
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self.device = None if device is None else torch.device(device)
        self._lock = threading.Lock()
        self._item_pool: Optional[ThreadPoolExecutor] = None
        self._batch_pool: Optional[ThreadPoolExecutor] = None
        self._finalizer = None

    def _pools(self):
        with self._lock:
            if self._item_pool is None:
                self._item_pool = ThreadPoolExecutor(
                    self.num_threads, thread_name_prefix="dvg-item")
            if self._batch_pool is None:
                self._batch_pool = ThreadPoolExecutor(
                    min(self.prefetch, 4), thread_name_prefix="dvg-batch")
            if self._finalizer is None:
                # a consumer that abandons iteration without stop() must not
                # leave builder threads running prefetch builds
                self._finalizer = weakref.finalize(
                    self, Loader._shutdown_pools,
                    self._item_pool, self._batch_pool)
            return self._item_pool, self._batch_pool

    @staticmethod
    def _shutdown_pools(item_pool, batch_pool):
        for pool in (item_pool, batch_pool):
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def next_batch(self, step: int):
        return self._build(step)

    def _indices(self, step: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, step))
            # INDEX_PURE datasets (any integer index is a fresh draw) get a
            # shuffle domain past len(), so a run is not capped at n
            # distinct windows
            hi = n * 65536 if getattr(self.dataset, "INDEX_PURE", False) else n
            return rng.integers(0, hi, self.batch_size)
        start = (step * self.batch_size) % n
        return (start + np.arange(self.batch_size)) % n

    def _build(self, step: int):
        """This rank's rows of step's batch."""
        if self.device is not None and hasattr(self.dataset, "device_batch"):
            return self.dataset.device_batch(
                self.batch_size, start_index=step * self.batch_size,
                device=self.device)[:, self.rows].contiguous()
        if hasattr(self.dataset, "sample_batch"):
            batch = np.ascontiguousarray(self.dataset.sample_batch(
                self.batch_size, start_index=step * self.batch_size
            )[:, self.rows])
        else:
            idxs = self._indices(step)[self.rows]
            if self.num_threads > 1:
                pool, _ = self._pools()
                items = list(pool.map(lambda i: self.dataset[int(i)][0], idxs))
            else:
                items = [self.dataset[int(i)][0] for i in idxs]
            batch = normalize_batch(items)
        if self.device is not None:
            return torch.from_numpy(batch).to(self.device)
        return batch

    def __iter__(self) -> Iterator:
        return self.iter_from(0)

    def iter_from(self, start_step: int) -> Iterator:
        """Endless prefetching iterator whose first batch is start_step's.
        Keeps `prefetch` batch futures in flight; a failing step's error
        surfaces in step order (its successors are cancelled first);
        `stop()` ends the iteration."""
        _, bpool = self._pools()
        futures = deque(bpool.submit(self._build, start_step + s)
                        for s in range(self.prefetch))
        step = start_step + self.prefetch
        while True:
            fut = futures.popleft()
            try:
                batch = fut.result()
            except CancelledError:         # stop() cancelled the pipeline
                return
            except BaseException:
                for f in futures:          # don't leak unretrieved errors
                    f.cancel()
                    if f.done() and not f.cancelled():
                        f.exception()
                raise
            try:
                futures.append(bpool.submit(self._build, step))
            except RuntimeError:           # pool shut down via stop()
                yield batch
                return
            step += 1
            yield batch

    def stop(self):
        with self._lock:
            if self._finalizer is not None:
                self._finalizer.detach()
                self._finalizer = None
            Loader._shutdown_pools(self._item_pool, self._batch_pool)
            self._item_pool = self._batch_pool = None
