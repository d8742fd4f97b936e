"""The assembled DVG model (counterpart of `dvg_tpu/models/dvg.py`): the
encoder/decoder of the backbone that (cfg.model, cfg.image_width) selects
in `models/registry.py` (DCGAN or VGG, 64 or 128 px), the `lstm` latent
predictor and the g_dim-task SVGP with its Gaussian likelihood, as one
`nn.Module` whose state_dict is the port's checkpoint state
(`convert.params_from_jax` builds one from the JAX package's pytrees).

Parameters are built with gradients on (torch's default): the train step
(`train/step.py`) takes them through the train-mode pieces
(`Encoder.train_forward`, `Decoder.grouped`,
`LSTMPredictor.teacher_forced`, `gp.elbo`). The entries below are the
eval-mode ones, and they run on one form of the model: the copy that
`fold_inference_params()` makes, every BatchNorm folded into its conv by
its running statistics (the rollouts' `prepare()` makes it on each call).
On the model itself the conv entries raise. The rollouts call them under
`torch.inference_mode()`, which records no graph.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

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
    def encode(self, x: torch.Tensor, skips: bool = True
               ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        """x (B, H, W, C) → (h (B, g_dim), skips); with `skips` False the
        skips are None, and the VGG encoder writes no full group map
        (`vgg.Encoder.forward`)."""
        return self.encoder(x, skips)

    def decode(self, h: torch.Tensor, skips: List[torch.Tensor]
               ) -> torch.Tensor:
        """Fused eval decode: (h (B, g_dim), skips) → x (B, H, W, C)."""
        return self.decoder(h, skips)

    def decode_skip_pre(self, skips: List[torch.Tensor]) -> List[torch.Tensor]:
        """The frozen-skip half of every decoder stage, computed once per
        rollout, for `decode_hoisted`."""
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

    def gp_posterior(self, h: torch.Tensor) -> gp_mod.GPPosterior:
        """h (B, g_dim) → q(f) of the next latent, in task layout (D, B)."""
        return gp_mod.posterior(self.gp, self.to_gp_layout(h))

    def gp_elbo(self, h: torch.Tensor, h_target: torch.Tensor,
                num_data: int) -> torch.Tensor:
        """Per-task ELBO (g_dim,) of h_target (B, g_dim) given h (B, g_dim)."""
        return gp_mod.elbo(self.gp, self.likelihood, self.to_gp_layout(h),
                           h_target.transpose(0, 1), num_data)

    def gp_mean(self, h: torch.Tensor) -> torch.Tensor:
        """Posterior predictive mean of the next latent, (B, g_dim)."""
        return self.from_gp_layout(self.gp_posterior(h).mean)

    def gp_rsample(self, h: torch.Tensor, full_cov: bool = False,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A sample of likelihood(gp(h)), (B, g_dim); eps, if given, is
        (B, g_dim) too (`gp_mod.rsample`)."""
        y = gp_mod.rsample(self.gp, self.likelihood, self.to_gp_layout(h),
                           full_cov, generator,
                           None if eps is None else eps.transpose(0, 1))
        return self.from_gp_layout(y)

    def gp_variance(self, h: torch.Tensor) -> torch.Tensor:
        """Predictive variance with the noise, (B, g_dim): the trigger's
        signal."""
        return self.from_gp_layout(gp_mod.predictive_variance(
            self.gp, self.likelihood, self.to_gp_layout(h)))

    def gp_cache(self) -> gp_mod.GPCache:
        return gp_mod.build_cache(self.gp, self.likelihood)

    def fold_inference_params(self) -> "DVGModel":
        """A copy with every eval-mode BatchNorm folded into its conv (f32
        math): the form the eval entries run."""
        folded = copy.deepcopy(self)
        folded.encoder.fold_()
        folded.decoder.fold_()
        return folded
