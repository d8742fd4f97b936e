"""Configuration and device selection for the PyTorch port.

`DVGConfig` is the port's own copy of `dvg_tpu/config.py::DVGConfig`: the
same field names, defaults and `to_dict`/`from_dict`, so a config written by
either package reads in the other. The port never imports `dvg_tpu`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass
class DVGConfig:
    # -- optimization --
    lr: float = 0.002
    beta1: float = 0.9
    batch_size: int = 50
    optimizer: str = "adam"
    niter: int = 601
    seed: int = 1
    epoch_size: int = 300

    # -- bookkeeping --
    log_dir: str = "logs"
    model_dir: str = ""
    name: str = ""
    output_path: str = "."
    data_root: str = "path/to/data/"

    # -- data/model geometry --
    image_width: int = 64
    channels: int = 1
    dataset: str = "kth"
    n_past: int = 5
    ft: bool = True
    n_future: int = 10
    n_eval: int = 15
    rnn_size: int = 256
    predictor_rnn_layers: int = 2
    z_dim: int = 10
    g_dim: int = 90
    model: str = "dcgan"
    data_threads: int = 5
    last_frame_skip: bool = False
    num_digits: int = 2

    # -- GP hyperparameters --
    num_inducing_points: int = 40
    gp_lr: float = 0.002
    gp_lr_milestones: tuple = (3, 5)
    gp_lr_gamma: float = 0.1

    # -- generation --
    gp_trigger_flag: bool = False
    trigger_sigma: float = 2.01
    trigger_margin: float = 0.0
    nsample: int = 100
    full_cov_sampling: bool = False

    # -- compute knobs (names shared with the JAX package) --
    dtype: str = "float32"          # compute dtype: 'float32' | 'bfloat16'
    use_pallas: bool = False        # metric through the hand-written kernel
    eval_metric: str = "skimage"    # 'skimage' | 'finn'
    remat: bool = False
    mesh_shape: tuple = ()
    jit_backend: str = ""

    @property
    def seq_len_train(self) -> int:
        return self.n_past + self.n_future

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DVGConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in fields})
        # tuples arrive as lists from JSON round-trips
        cfg.gp_lr_milestones = tuple(cfg.gp_lr_milestones)
        cfg.mesh_shape = tuple(tuple(x) for x in cfg.mesh_shape)
        return cfg

    def generation_override(self) -> "DVGConfig":
        """The restore-then-override contract of the reference's
        generation script: a checkpoint's config with the eval protocol's
        n_eval 105, n_future 100 and batch 50."""
        return dataclasses.replace(self, n_eval=105, n_future=100,
                                   batch_size=50)

    def replace(self, **kw) -> "DVGConfig":
        return dataclasses.replace(self, **kw)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Defaults to the card; asking for
    CUDA where there is none raises instead of dropping to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dvg_tpu_torch: device 'cuda' requested but torch.cuda is not "
            "available; pass device='cpu' explicitly to run on the CPU")
    return dev


def compute_dtype(cfg: DVGConfig) -> torch.dtype:
    if cfg.dtype == "bfloat16":
        return torch.bfloat16
    if cfg.dtype == "float32":
        return torch.float32
    raise ValueError(
        f"dtype must be 'float32' or 'bfloat16', got {cfg.dtype!r}")
