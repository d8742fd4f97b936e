"""Carry weights from the JAX package's (params, stats) pytrees into the
port's `DVGModel` state_dict.

Layout maps (the JAX package keeps NHWC activations and HWIO kernels):
  Conv2d          HWIO → (O, I, kh, kw)   w.transpose(3, 2, 0, 1)
  ConvTranspose2d HWIO → (I, O, kh, kw)   w[::-1, ::-1].transpose(2, 3, 0, 1)
                  (lax.conv_transpose applies the kernel unflipped; torch's
                  transposed conv is the flipped-kernel gradient op)
  Linear          (in, out) → (out, in)   w.T
  LSTMCell        (·, 4H) → (4H, ·)       w.T, gate order i, f, g, o in both
  BatchNorm       scale/bias/mean/var → weight/bias/running_mean/running_var
  GP, likelihood  same shapes and names
Leaves may be numpy arrays or anything `np.asarray` takes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dvg_tpu_torch.config import DVGConfig


def _t(a) -> torch.Tensor:
    return torch.tensor(np.array(a, np.float32))


def conv_weight(w) -> torch.Tensor:
    return _t(np.asarray(w).transpose(3, 2, 0, 1))


def conv_transpose_weight(w) -> torch.Tensor:
    return _t(np.asarray(w)[::-1, ::-1].transpose(2, 3, 0, 1))


def _block(out: Dict, prefix: str, p: Dict, s: Dict, conv) -> None:
    out[f"{prefix}.conv.weight"] = conv(p["conv"]["w"])
    out[f"{prefix}.conv.bias"] = _t(p["conv"]["b"])
    out[f"{prefix}.bn.weight"] = _t(p["bn"]["scale"])
    out[f"{prefix}.bn.bias"] = _t(p["bn"]["bias"])
    out[f"{prefix}.bn.running_mean"] = _t(s["bn"]["mean"])
    out[f"{prefix}.bn.running_var"] = _t(s["bn"]["var"])
    out[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)


def params_from_jax(params: Dict, stats: Dict, cfg: DVGConfig
                    ) -> Dict[str, torch.Tensor]:
    """dvg_tpu `(params, stats)` of a DCGAN-64 `lstm` model → a state_dict
    for `DVGModel(cfg)` (CPU tensors; `load_state_dict` moves them)."""
    if cfg.model != "dcgan" or cfg.image_width != 64:
        raise NotImplementedError(
            "params_from_jax: only DCGAN-64 is ported (ROADMAP queue 1 "
            "item 13)")
    out: Dict[str, torch.Tensor] = {}
    enc_p, enc_s = params["encoder"], stats["encoder"]
    for i, (p, s) in enumerate(zip(enc_p["stages"], enc_s["stages"])):
        _block(out, f"encoder.stages.{i}", p, s, conv_weight)
    _block(out, "encoder.head", enc_p["head"], enc_s["head"], conv_weight)

    dec_p, dec_s = params["decoder"], stats["decoder"]
    _block(out, "decoder.head", dec_p["head"], dec_s["head"],
           conv_transpose_weight)
    for i, (p, s) in enumerate(zip(dec_p["stages"], dec_s["stages"])):
        _block(out, f"decoder.stages.{i}", p, s, conv_transpose_weight)
    out["decoder.final.weight"] = conv_transpose_weight(dec_p["final"]["w"])
    out["decoder.final.bias"] = _t(dec_p["final"]["b"])

    fp = params["frame_predictor"]
    for name in ("embed", "output"):
        out[f"frame_predictor.{name}.weight"] = _t(np.asarray(fp[name]["w"]).T)
        out[f"frame_predictor.{name}.bias"] = _t(fp[name]["b"])
    for i, cell in enumerate(fp["cells"]):
        for k in ("w_ih", "w_hh"):
            out[f"frame_predictor.cells.{i}.weight_{k[2:]}"] = _t(
                np.asarray(cell[k]).T)
        for k in ("b_ih", "b_hh"):
            out[f"frame_predictor.cells.{i}.bias_{k[2:]}"] = _t(cell[k])

    for k, v in params["gp"].items():
        out[f"gp.{k}"] = _t(v)
    out["likelihood.raw_noise"] = _t(params["likelihood"]["raw_noise"])
    return out
