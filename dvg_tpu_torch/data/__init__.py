"""Dataset layer of the port (counterpart of `dvg_tpu/data`): map-style
datasets (`MovingMNIST`, `BAIR`, `KTH`, `UCF`) returning float32
(T, H, W, C) sequences in [0, 1], the `load_dataset` registry, and the
`Loader` that builds time-major (T, B, H, W, C) batches on the host or on
a device."""

from dvg_tpu_torch.data.frames import BAIR, KTH, UCF
from dvg_tpu_torch.data.moving_mnist import MovingMNIST
from dvg_tpu_torch.data.pipeline import Loader, load_dataset, normalize_batch

__all__ = [
    "MovingMNIST", "BAIR", "KTH", "UCF",
    "Loader", "load_dataset", "normalize_batch",
]
