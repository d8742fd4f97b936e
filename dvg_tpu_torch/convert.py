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
The backbones' trees map by name, whichever of the four it is: DCGAN's
`stages.{i}`, VGG's `groups.{i}.{j}`, each encoder's and decoder's `head`
and the decoder's bare `final` conv. The decoder's head, DCGAN's decoder
stages and both finals are transposed convs; VGG's decoder groups are
plain convs (`TRANSPOSED`).
The modules off the model's path map from their `dvg_tpu` trees too:
`predictor_from_jax` (lstm, gru, rnn and gaussian_lstm predictors),
`gaussian_encoder_from_jax` (VGG's Gaussian encoder) and
`classifier_from_jax` (CNNBlockFrame/3: Conv3d DHWIO → (O, I, kd, kh, kw),
BatchNorm3d; MLP/MLP2).
Leaves may be numpy arrays or anything `np.asarray` takes. Values are f32,
or f64 where they come in as f64 (the f64 parity tests). Every map is an
exact permutation or flip, so a round trip is bit-exact.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


# the encoder's and decoder's parts whose convs are transposed; the rest
# (every encoder conv, VGG's decoder groups) are Conv2d
TRANSPOSED = {("decoder", "head"), ("decoder", "stages"), ("decoder", "final")}


def _block(out: Dict, prefix: str, p: Dict, s: Dict, conv) -> None:
    out[f"{prefix}.conv.weight"] = conv(p["conv"]["w"])
    out[f"{prefix}.conv.bias"] = _t(p["conv"]["b"])
    out[f"{prefix}.bn.weight"] = _t(p["bn"]["scale"])
    out[f"{prefix}.bn.bias"] = _t(p["bn"]["bias"])
    out[f"{prefix}.bn.running_mean"] = _t(s["bn"]["mean"])
    out[f"{prefix}.bn.running_var"] = _t(s["bn"]["var"])
    out[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)


def _convs(tree, path: Tuple = ()):
    """(path, node) of every conv+BN block ({conv, bn}) and bare conv ({w,
    b}) of a backbone's params tree; lists index by position."""
    if isinstance(tree, dict) and ("conv" in tree or "w" in tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _convs(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _convs(v, path + (i,))


def _at(tree, path: Tuple):
    for k in path:
        tree = tree[k]
    return tree


def _check_backbone(params: Dict, cfg: DVGConfig) -> None:
    """The tree is the backbone cfg names: its stages (DCGAN) or groups
    (VGG), one per skip."""
    parts = "groups" if cfg.model == "vgg" else "stages"
    want = 4 if cfg.image_width == 64 else 5
    enc = params["encoder"]
    if parts not in enc or len(enc[parts]) != want:
        have = {k: len(v) for k, v in enc.items() if isinstance(v, list)}
        raise ValueError(
            f"the weights' encoder has {have}, but model={cfg.model!r} at "
            f"image_width={cfg.image_width} has {want} {parts}")


def _linear(out: Dict, prefix: str, p: Dict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    out[f"{prefix}.bias"] = _t(p["b"])


def _backbone(out: Dict, prefix: str, part: str, params: Dict,
              stats: Dict) -> None:
    """The conv blocks and bare convs of an encoder or decoder (`part`)
    tree, under `prefix`."""
    for path, p in _convs(params):
        name = ".".join(map(str, (prefix,) + path))
        conv = (conv_transpose_weight if (part, path[0]) in TRANSPOSED
                else conv_weight)
        if "conv" in p:
            _block(out, name, p, _at(stats, path), conv)
        else:
            out[f"{name}.weight"] = conv(p["w"])
            out[f"{name}.bias"] = _t(p["b"])


def predictor_from_jax(params: Dict, prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """A `dvg_tpu` predictor's params (lstm, gru, rnn or gaussian_lstm) →
    the state_dict of the port's module (`models/rnn.py`), keys under
    `prefix`: its Linears (embed, and output or mu and logvar) transposed,
    each cell's fused (in, k·H) weights as torch's (k·H, in), the gates in
    the same order in both."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if name != "cells":
            _linear(out, prefix + name, p)
            continue
        for i, cell in enumerate(p):
            for k in ("w_ih", "w_hh"):
                out[f"{prefix}cells.{i}.weight_{k[2:]}"] = _t(
                    np.asarray(cell[k]).T)
            for k in ("b_ih", "b_hh"):
                out[f"{prefix}cells.{i}.bias_{k[2:]}"] = _t(cell[k])
    return out


def gaussian_encoder_from_jax(params: Dict, stats: Dict
                              ) -> Dict[str, torch.Tensor]:
    """`dvg_tpu`'s gaussian_encoder (params, stats) → the state_dict of
    `models.vgg.GaussianEncoder`."""
    out: Dict[str, torch.Tensor] = {}
    _backbone(out, "trunk", "encoder", params["trunk"], stats["trunk"])
    for name in ("mu", "logvar"):
        _linear(out, name, params[name])
    return out


def classifier_from_jax(params: Dict, stats: Optional[Dict] = None
                        ) -> Dict[str, torch.Tensor]:
    """A `dvg_tpu` classifier's (params, stats) → the state_dict of
    `models.classifiers`' CNNBlockFrame/3 or MLP/MLP2 (MLPs have no
    stats)."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if "scale" in p:
            out[f"{name}.weight"] = _t(p["scale"])
            out[f"{name}.bias"] = _t(p["bias"])
            out[f"{name}.running_mean"] = _t(stats[name]["mean"])
            out[f"{name}.running_var"] = _t(stats[name]["var"])
            out[f"{name}.num_batches_tracked"] = torch.tensor(0)
        elif np.ndim(p["w"]) == 5:
            out[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(
                4, 3, 0, 1, 2))
            out[f"{name}.bias"] = _t(p["b"])
        else:
            _linear(out, name, p)
    return out


def params_from_jax(params: Dict, stats: Dict, cfg: DVGConfig
                    ) -> Dict[str, torch.Tensor]:
    """dvg_tpu `(params, stats)` of an `lstm` model with any of the four
    backbones → a state_dict for `DVGModel(cfg)` (CPU tensors;
    `load_state_dict` moves them). The backbone's tree maps by name:
    `stages.{i}` (DCGAN), `groups.{i}.{j}` (VGG), `head`, `final`."""
    _check_backbone(params, cfg)
    out: Dict[str, torch.Tensor] = {}
    for part in ("encoder", "decoder"):
        _backbone(out, part, part, params[part], stats[part])
    out.update(predictor_from_jax(params["frame_predictor"],
                                  "frame_predictor."))
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


def _lists(tree):
    """Maps keyed exactly "0".."n−1" → lists, recursively."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and sorted(out) == sorted(str(i) for i in range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def _backbone_to_jax(sd: Dict[str, torch.Tensor], part: str
                     ) -> Tuple[Dict, Dict]:
    """The `part` ("encoder" or "decoder") entries of a state_dict → its
    (params, stats) trees in the JAX layout: nested by the names' dotted
    paths, numbered levels as lists."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree: Dict, path, value) -> None:
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    for key in sd:
        if not key.startswith(f"{part}.") or not key.endswith(".weight"):
            continue
        path = key[:-len(".weight")].split(".")[1:]
        if path[-1] == "bn":
            continue
        transposed = (part, path[0]) in TRANSPOSED
        conv = conv_transpose_weight_to_jax if transposed else \
            conv_weight_to_jax
        if path[-1] == "conv":                     # a conv+BN block
            p, s = _block_to_jax(sd, ".".join([part] + path[:-1]), conv)
            put(params, path[:-1], p)
            put(stats, path[:-1], s)
        else:                                       # a bare conv (final)
            put(params, path, {"b": _np(sd[f"{part}.{'.'.join(path)}.bias"]),
                               "w": conv(sd[key])})
    return _lists(params), _lists(stats)


def params_to_jax(sd: Dict[str, torch.Tensor], cfg: DVGConfig
                  ) -> Tuple[Dict, Dict]:
    """A `DVGModel` state_dict → dvg_tpu `(params, stats)` of an `lstm`
    model: nested dicts and lists of f32 numpy arrays, the inverse of
    `params_from_jax`."""
    enc_p, enc_s = _backbone_to_jax(sd, "encoder")
    dec_p, dec_s = _backbone_to_jax(sd, "decoder")
    _check_backbone({"encoder": enc_p}, cfg)
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
        "decoder": dec_p,
        "encoder": enc_p,
        "frame_predictor": fp,
        "gp": {k[len("gp."):]: _np(v) for k, v in sd.items()
               if k.startswith("gp.")},
        "likelihood": {"raw_noise": _np(sd["likelihood.raw_noise"])},
    }
    stats = {"decoder": dec_s, "encoder": enc_s}
    return params, stats
