"""The assembled DVG model (counterpart of `dvg_tpu/models/dvg.py`): the
encoder/decoder of the backbone that (cfg.model, cfg.image_width) selects
in `models/registry.py` (DCGAN or VGG, 64 or 128 px), the `lstm` latent
predictor and the g_dim-task SVGP with its Gaussian likelihood, as one
`nn.Module` whose state_dict is the port's checkpoint state
(`convert.params_from_jax` builds one from the JAX package's pytrees).

Parameters are built with gradients on (torch's default): the train step
(`train/step.py`) takes them through the train-mode pieces
(`Encoder.train_forward`, `Decoder.grouped`,
`LSTMPredictor.teacher_forced`, `gp.elbo`), and the entries below are the
eval-mode ones, which BatchNorm runs with its running statistics. The
rollouts call them under `torch.inference_mode()`, which records no graph.
"""

from __future__ import annotations

import copy
from typing import List, Tuple

import torch
from torch import nn

from dvg_tpu_torch.config import DVGConfig, resolve_device
from dvg_tpu_torch.models import gp as gp_mod
from dvg_tpu_torch.models import layers as L
from dvg_tpu_torch.models.registry import get_backbone
from dvg_tpu_torch.models.rnn import Hidden, LSTMPredictor


class DVGModel(nn.Module):
    def __init__(self, cfg: DVGConfig, seed: int = 0, device="cuda"):
        """Weights drawn from `torch.Generator().manual_seed(seed)` on the
        CPU, then moved to `device`, so the card and the CPU start from
        identical weights."""
        super().__init__()
        dev = resolve_device(device)
        backbone = get_backbone(cfg.model, cfg.image_width)
        self.cfg = cfg
        with torch.device("meta"):          # no work for torch's own init
            self.encoder = backbone.encoder(cfg.g_dim, cfg.channels)
            self.decoder = backbone.decoder(cfg.g_dim, cfg.channels)
            self.frame_predictor = LSTMPredictor(
                cfg.g_dim, cfg.g_dim, cfg.rnn_size, cfg.predictor_rnn_layers)
            self.gp = gp_mod.SVGP(cfg.g_dim, cfg.num_inducing_points)
            self.likelihood = gp_mod.GaussianLikelihood(cfg.g_dim)
        self.to_empty(device="cpu")
        gen = torch.Generator().manual_seed(seed)
        L.init_weights(self, gen)
        self.frame_predictor.init_cells(gen)
        self.gp.init(gen)
        self.likelihood.init()
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.gp.z.device

    # -- pieces (all NHWC at the boundary) ------------------------------------
    def encode(self, x: torch.Tensor
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, H, W, C) → (h (B, g_dim), skips)."""
        return self.encoder(x)

    def decode(self, h: torch.Tensor, skips: List[torch.Tensor]
               ) -> torch.Tensor:
        """Fused eval decode: (h (B, g_dim), skips) → x (B, H, W, C)."""
        return self.decoder(h, skips)

    def decode_skip_pre(self, skips: List[torch.Tensor]) -> List[torch.Tensor]:
        """The frozen-skip half of every decoder stage, computed once per
        rollout. Pair with `decode_hoisted` on BN-folded weights."""
        return self.decoder.skip_pre(skips)

    def decode_hoisted(self, h: torch.Tensor, skip_pre: List[torch.Tensor]
                       ) -> torch.Tensor:
        return self.decoder.hoisted(h, skip_pre)

    def lstm_hidden_init(self, batch_size: int,
                         dtype: torch.dtype = torch.float32) -> Hidden:
        return self.frame_predictor.hidden_init(batch_size, dtype,
                                                self.device)

    def predict_latent(self, hidden: Hidden, h: torch.Tensor
                       ) -> Tuple[torch.Tensor, Hidden]:
        """One LSTM step: latent h_t → h_{t+1} prediction."""
        return self.frame_predictor(hidden, h)

    # -- GP over latents. Latent (B, g_dim) ⇄ GP task layout (g_dim, B, 1) ----
    @staticmethod
    def to_gp_layout(h: torch.Tensor) -> torch.Tensor:
        return h.transpose(0, 1)[..., None]

    @staticmethod
    def from_gp_layout(y: torch.Tensor) -> torch.Tensor:
        return y.transpose(0, 1)

    def gp_cache(self) -> gp_mod.GPCache:
        return gp_mod.build_cache(self.gp, self.likelihood)

    def fold_inference_params(self) -> "DVGModel":
        """A copy with every eval-mode BatchNorm folded into its conv (f32
        math): the same outputs, minus one elementwise pass per block."""
        folded = copy.deepcopy(self)
        folded.encoder.fold_()
        folded.decoder.fold_()
        return folded
