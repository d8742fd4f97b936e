"""Carry weights between the JAX package's (params, stats) pytrees and the
port's `DVGModel` state_dict: `params_from_jax` and its inverse
`params_to_jax`.

Layout maps (the JAX package keeps NHWC activations and HWIO kernels):
  Conv2d          HWIO → (O, I, kh, kw)   w.transpose(3, 2, 0, 1)
  ConvTranspose2d HWIO → (I, O, kh, kw)   w[::-1, ::-1].transpose(2, 3, 0, 1)
                  (lax.conv_transpose applies the kernel unflipped; torch's
                  transposed conv is the flipped-kernel gradient op)
  Linear          (in, out) → (out, in)   w.T
  LSTMCell        (·, 4H) → (4H, ·)       w.T, gate order i, f, g, o in both
  BatchNorm       scale/bias/mean/var → weight/bias/running_mean/running_var
  GP, likelihood  same shapes and names
Leaves may be numpy arrays or anything `np.asarray` takes. Values are f32,
or f64 where they come in as f64 (the f64 parity tests). Every map is an
exact permutation or flip, so a round trip is bit-exact.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dvg_tpu_torch.config import DVGConfig


def _float_dtype(dtype) -> type:
    return np.float64 if dtype == np.float64 else np.float32


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.tensor(np.array(a, _float_dtype(a.dtype)))


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


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy, never a view of the tensor's memory: the port updates its
    tensors in place, and a consumer may alias the numpy buffer it is
    given (JAX does on the CPU)."""
    t = t.detach().cpu()
    return (t if t.dtype == torch.float64 else t.float()).numpy().copy()


def _block_to_jax(sd: Dict[str, torch.Tensor], prefix: str, conv
                  ) -> Tuple[Dict, Dict]:
    p = {"bn": {"bias": _np(sd[f"{prefix}.bn.bias"]),
                "scale": _np(sd[f"{prefix}.bn.weight"])},
         "conv": {"b": _np(sd[f"{prefix}.conv.bias"]),
                  "w": conv(sd[f"{prefix}.conv.weight"])}}
    s = {"bn": {"mean": _np(sd[f"{prefix}.bn.running_mean"]),
                "var": _np(sd[f"{prefix}.bn.running_var"])}}
    return p, s


def conv_weight_to_jax(w: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(_np(w).transpose(2, 3, 1, 0))


def conv_transpose_weight_to_jax(w: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(_np(w).transpose(2, 3, 0, 1)[::-1, ::-1])


def params_to_jax(sd: Dict[str, torch.Tensor], cfg: DVGConfig
                  ) -> Tuple[Dict, Dict]:
    """A `DVGModel` state_dict → dvg_tpu `(params, stats)` of a DCGAN-64
    `lstm` model: nested dicts and lists of f32 numpy arrays, the inverse
    of `params_from_jax`."""
    if cfg.model != "dcgan" or cfg.image_width != 64:
        raise NotImplementedError(
            "params_to_jax: only DCGAN-64 is ported (ROADMAP queue 1 "
            "item 13)")

    def stages(prefix: str, conv):
        n = len({k.split(".")[2] for k in sd if k.startswith(prefix)})
        pairs = [_block_to_jax(sd, f"{prefix}.{i}", conv) for i in range(n)]
        return [p for p, _ in pairs], [s for _, s in pairs]

    enc_p, enc_s = stages("encoder.stages", conv_weight_to_jax)
    head_p, head_s = _block_to_jax(sd, "encoder.head", conv_weight_to_jax)
    dec_p, dec_s = stages("decoder.stages", conv_transpose_weight_to_jax)
    dhead_p, dhead_s = _block_to_jax(sd, "decoder.head",
                                     conv_transpose_weight_to_jax)
    n_cells = len({k.split(".")[2] for k in sd
                   if k.startswith("frame_predictor.cells.")})

    def linear_w(k: str) -> np.ndarray:
        return np.ascontiguousarray(_np(sd[k]).T)

    fp = {name: {"b": _np(sd[f"frame_predictor.{name}.bias"]),
                 "w": linear_w(f"frame_predictor.{name}.weight")}
          for name in ("embed", "output")}
    fp["cells"] = []
    for i in range(n_cells):
        c = f"frame_predictor.cells.{i}"
        fp["cells"].append({"b_hh": _np(sd[f"{c}.bias_hh"]),
                            "b_ih": _np(sd[f"{c}.bias_ih"]),
                            "w_hh": linear_w(f"{c}.weight_hh"),
                            "w_ih": linear_w(f"{c}.weight_ih")})
    params = {
        "decoder": {"final": {"b": _np(sd["decoder.final.bias"]),
                              "w": conv_transpose_weight_to_jax(
                                  sd["decoder.final.weight"])},
                    "head": dhead_p, "stages": dec_p},
        "encoder": {"head": head_p, "stages": enc_p},
        "frame_predictor": fp,
        "gp": {k[len("gp."):]: _np(v) for k, v in sd.items()
               if k.startswith("gp.")},
        "likelihood": {"raw_noise": _np(sd["likelihood.raw_noise"])},
    }
    stats = {"decoder": {"head": dhead_s, "stages": dec_s},
             "encoder": {"head": head_s, "stages": enc_s}}
    return params, stats
