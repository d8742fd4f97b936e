"""Import a reference checkpoint (`model.pth`) into the port, and write one
(counterpart of `dvg_tpu/train/import_torch.py`):

    python -m dvg_tpu_torch.train.import_torch model.pth RUN [--device cpu]

1. **Unpickling.** The reference saves WHOLE nn.Module objects for the
   encoder, decoder and frame_predictor and state_dicts for the GP layer
   and likelihood (reference train.py:380-388). Unpickling them needs
   classes at the reference's module paths (`models.dcgan_64.encoder`, …):
   `_reference_shim` installs this file's re-implementations of those
   architectures (reference models/dcgan_64.py:28-88, dcgan_128.py:28-94,
   vgg_64.py:17-106, vgg_128.py, lstm.py:42-72) under those names for the
   duration of `torch.load`.
2. **Converters.** `t2j_*` and the backbone maps turn the reference's
   tensors into the shared (JAX-layout) numpy trees that `dvg_tpu`
   checkpoints hold; `convert.params_from_jax` maps those into the port's
   modules. The `j2t_*` maps go back, filling reference modules
   (`reference_modules`), and `save_reference_style_checkpoint` writes a
   `.pth` in the reference's schema.
3. **`import_checkpoint`** writes a whole TrainState (fresh optimizers,
   step 0) in the dvg_tpu format, the file `dvg_tpu`'s importer writes.

Layouts (the shared tree keeps HWIO kernels):
  Conv2d        torch (O,I,kh,kw)  →  HWIO  w.transpose(2,3,1,0)
  ConvTranspose torch (I,O,kh,kw)  →  HWIO  w[:,:,::-1,::-1].transpose(2,3,0,1)
                (lax.conv_transpose applies the kernel unflipped; torch's
                 transposed conv is the flipped-kernel gradient op)
  Linear        torch (out,in)     →  (in,out)  w.T
  LSTMCell      torch (4H,·) gate order i,f,g,o → (·,4H)  w.T
  BatchNorm     weight/bias/running_mean/running_var map 1:1
  GP (gpytorch state_dict, whitened strategy, the parameterization of
  models/gp.py): inducing_points→z, variational_mean→var_mean,
  chol_variational_covar→var_chol, mean constant, raw_{outputscale,
  lengthscale,noise} (the softplus constraints match).
The port's ConvTranspose2d keeps the reference's (I,O,kh,kw) layout, so
`convert.conv_transpose_weight(t2j_convT(w))` is `w` itself: the flip of
t2j_convT and the flip of the shared tree's map cancel.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import types
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from dvg_tpu_torch.checkpoint import save_train_state
from dvg_tpu_torch.config import DVGConfig, resolve_device
from dvg_tpu_torch.convert import params_from_jax, params_to_jax
from dvg_tpu_torch.train.step import init_train_state


# ===========================================================================
# reference-architecture modules (attribute layout as the reference's)
# ===========================================================================

class dcgan_conv(nn.Module):
    def __init__(self, nin, nout):
        super().__init__()
        self.main = nn.Sequential(nn.Conv2d(nin, nout, 4, 2, 1),
                                  nn.BatchNorm2d(nout),
                                  nn.LeakyReLU(0.2, inplace=True))

    def forward(self, x):
        return self.main(x)


class dcgan_upconv(nn.Module):
    def __init__(self, nin, nout):
        super().__init__()
        self.main = nn.Sequential(nn.ConvTranspose2d(nin, nout, 4, 2, 1),
                                  nn.BatchNorm2d(nout),
                                  nn.LeakyReLU(0.2, inplace=True))

    def forward(self, x):
        return self.main(x)


class vgg_layer(nn.Module):
    def __init__(self, nin, nout):
        super().__init__()
        self.main = nn.Sequential(nn.Conv2d(nin, nout, 3, 1, 1),
                                  nn.BatchNorm2d(nout),
                                  nn.LeakyReLU(0.2, inplace=True))

    def forward(self, x):
        return self.main(x)


def _dcgan_enc_stages(image_width, nc):
    nf = 64
    if image_width == 64:
        return [(nc, nf), (nf, nf * 2), (nf * 2, nf * 4), (nf * 4, nf * 8)]
    return [(nc, nf), (nf, nf * 2), (nf * 2, nf * 4), (nf * 4, nf * 8),
            (nf * 8, nf * 8)]


class DcganEncoder(nn.Module):
    """dcgan_64.py:28-54 / dcgan_128.py:28-57: c1..cN stages and a
    conv/BN/Tanh head as c{N+1}. forward finds the stage count on the
    instance, so unpickled reference objects (which bypass __init__) run
    with it too."""

    def __init__(self, dim, nc=1, image_width=64):
        super().__init__()
        self.dim = dim
        stages = _dcgan_enc_stages(image_width, nc)
        for i, (ci, co) in enumerate(stages):
            setattr(self, f"c{i + 1}", dcgan_conv(ci, co))
        setattr(self, f"c{len(stages) + 1}", nn.Sequential(
            nn.Conv2d(stages[-1][1], dim, 4, 1, 0),
            nn.BatchNorm2d(dim), nn.Tanh()))

    def forward(self, x):
        skips = []
        h, i = x, 1
        while hasattr(self, f"c{i + 1}"):
            h = getattr(self, f"c{i}")(h)
            skips.append(h)
            i += 1
        h = getattr(self, f"c{i}")(h)
        return h.view(-1, self.dim), skips


def _dcgan_dec_stages(image_width):
    nf = 64
    if image_width == 64:
        return [(nf * 8 * 2, nf * 4), (nf * 4 * 2, nf * 2),
                (nf * 2 * 2, nf)]
    return [(nf * 8 * 2, nf * 8), (nf * 8 * 2, nf * 4),
            (nf * 4 * 2, nf * 2), (nf * 2 * 2, nf)]


class DcganDecoder(nn.Module):
    """dcgan_64.py:57-88 / dcgan_128.py:60-94: upc1 head, upc2..upc(N-1)
    skip-concat upconv stages, upcN final ConvTranspose + Tanh (64 px) /
    Sigmoid (128 px, the reference's choice)."""

    def __init__(self, dim, nc=1, image_width=64):
        super().__init__()
        self.dim = dim
        nf = 64
        self.upc1 = nn.Sequential(nn.ConvTranspose2d(dim, nf * 8, 4, 1, 0),
                                  nn.BatchNorm2d(nf * 8),
                                  nn.LeakyReLU(0.2, inplace=True))
        stages = _dcgan_dec_stages(image_width)
        for i, (ci, co) in enumerate(stages):
            setattr(self, f"upc{i + 2}", dcgan_upconv(ci, co))
        act = nn.Tanh() if image_width == 64 else nn.Sigmoid()
        setattr(self, f"upc{len(stages) + 2}", nn.Sequential(
            nn.ConvTranspose2d(nf * 2, nc, 4, 2, 1), act))

    def forward(self, inp):
        vec, skip = inp
        d = self.upc1(vec.view(-1, self.dim, 1, 1))
        n = 2
        while hasattr(self, f"upc{n + 1}"):
            d = getattr(self, f"upc{n}")(torch.cat([d, skip[-(n - 1)]], 1))
            n += 1
        return getattr(self, f"upc{n}")(torch.cat([d, skip[0]], 1))


def _vgg_enc_groups(image_width, nc):
    groups = [[nc, 64, 64], [64, 128, 128], [128, 256, 256, 256],
              [256, 512, 512, 512]]
    if image_width == 128:
        groups.append([512, 512, 512, 512])
    return groups


class VggEncoder(nn.Module):
    """vgg_64.py:17-57 / vgg_128.py: c1..cN vgg_layer groups with a
    max-pool between, a conv/BN/Tanh head as c{N+1}."""

    def __init__(self, dim, nc=1, image_width=64):
        super().__init__()
        self.dim = dim
        groups = _vgg_enc_groups(image_width, nc)
        for i, chain in enumerate(groups):
            setattr(self, f"c{i + 1}", nn.Sequential(
                *[vgg_layer(a, b) for a, b in zip(chain[:-1], chain[1:])]))
        setattr(self, f"c{len(groups) + 1}", nn.Sequential(
            nn.Conv2d(groups[-1][-1], dim, 4, 1, 0),
            nn.BatchNorm2d(dim), nn.Tanh()))
        self.mp = nn.MaxPool2d(kernel_size=2, stride=2, padding=0)

    def forward(self, x):
        skips = []
        h, i = x, 1
        while hasattr(self, f"c{i + 1}"):
            if i > 1:
                h = self.mp(h)
            h = getattr(self, f"c{i}")(h)
            skips.append(h)
            i += 1
        h = getattr(self, f"c{i}")(self.mp(h))
        return h.view(-1, self.dim), skips


def _vgg_dec_groups(image_width):
    groups = [[512 * 2, 512, 512, 256], [256 * 2, 256, 256, 128],
              [128 * 2, 128, 64], [64 * 2, 64]]
    if image_width == 128:
        groups.insert(0, [512 * 2, 512, 512, 512])
    return groups


class VggDecoder(nn.Module):
    """vgg_64.py:60-106 / vgg_128.py: upc1 ConvT head, a nearest upsample
    and skip concat before each vgg_layer group; the LAST group's
    Sequential also carries the final ConvTranspose + Sigmoid
    (vgg_64.py:89-93)."""

    def __init__(self, dim, nc=1, image_width=64):
        super().__init__()
        self.dim = dim
        self.upc1 = nn.Sequential(nn.ConvTranspose2d(dim, 512, 4, 1, 0),
                                  nn.BatchNorm2d(512),
                                  nn.LeakyReLU(0.2, inplace=True))
        groups = _vgg_dec_groups(image_width)
        for i, chain in enumerate(groups):
            mods = [vgg_layer(a, b) for a, b in zip(chain[:-1], chain[1:])]
            if i == len(groups) - 1:
                mods += [nn.ConvTranspose2d(chain[-1], nc, 3, 1, 1),
                         nn.Sigmoid()]
            setattr(self, f"upc{i + 2}", nn.Sequential(*mods))
        self.up = nn.UpsamplingNearest2d(scale_factor=2)

    def forward(self, inp):
        vec, skip = inp
        d = self.upc1(vec.view(-1, self.dim, 1, 1))
        n = 2
        while hasattr(self, f"upc{n}"):
            d = getattr(self, f"upc{n}")(
                torch.cat([self.up(d), skip[-(n - 1)]], 1))
            n += 1
        return d


class RefLSTM(nn.Module):
    """lstm.py:42-72, with the hidden state made on the module's own
    device (the reference hardcodes .cuda(), lstm.py:24-25)."""

    def __init__(self, input_size, output_size, hidden_size, n_layers,
                 batch_size):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.hidden_size = hidden_size
        self.batch_size = batch_size
        self.n_layers = n_layers
        self.embed = nn.Linear(input_size, hidden_size)
        self.lstm = nn.ModuleList(
            [nn.LSTMCell(hidden_size, hidden_size) for _ in range(n_layers)])
        self.output = nn.Sequential(nn.Linear(hidden_size, output_size),
                                    nn.Tanh())
        self.hidden = self.init_hidden()

    def init_hidden(self, batch_size=None):
        b = batch_size or self.batch_size
        dev = self.embed.weight.device
        return [(torch.zeros(b, self.hidden_size, device=dev),
                 torch.zeros(b, self.hidden_size, device=dev))
                for _ in range(self.n_layers)]

    def forward(self, x):
        h_in = self.embed(x.view(-1, self.input_size))
        for i in range(self.n_layers):
            self.hidden[i] = self.lstm[i](h_in, self.hidden[i])
            h_in = self.hidden[i][0]
        return self.output(h_in)


# the reference's backbone modules: (model, image width) → module name
BACKBONE_MODULES = {("dcgan", 64): "dcgan_64", ("dcgan", 128): "dcgan_128",
                    ("vgg", 64): "vgg_64", ("vgg", 128): "vgg_128"}


@contextlib.contextmanager
def _reference_shim():
    """Install the reference's module paths (models.dcgan_64 …) in
    sys.modules, so torch.load can unpickle the whole modules a reference
    checkpoint holds; restores what was there before."""
    mods = {}
    pkg = types.ModuleType("models")
    pkg.__path__ = []
    mods["models"] = pkg
    for (model, width), name in BACKBONE_MODULES.items():
        m = types.ModuleType(f"models.{name}")
        if model == "dcgan":
            m.encoder, m.decoder = DcganEncoder, DcganDecoder
        else:
            m.encoder, m.decoder = VggEncoder, VggDecoder
        m.dcgan_conv, m.dcgan_upconv = dcgan_conv, dcgan_upconv
        m.vgg_layer = vgg_layer
        mods[f"models.{name}"] = m
        setattr(pkg, name, m)
    lm = types.ModuleType("models.lstm")
    lm.lstm = RefLSTM
    mods["models.lstm"] = lm
    pkg.lstm = lm
    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def load_reference_checkpoint(path: str):
    """torch.load a reference model.pth onto the CPU. The file pickles
    whole modules, which torch's default weights_only=True refuses: the
    user's own checkpoint, the trust the reference extends to it."""
    with _reference_shim():
        return torch.load(path, map_location="cpu", weights_only=False)


@contextlib.contextmanager
def _reference_identity(model: str, width: int):
    """Name this file's classes as the reference's for the backbone
    (model, width) — models.<model>_<width>.encoder, .decoder and its
    blocks, models.lstm.lstm — so torch.save writes reference-schema
    pickles; restores their names after."""
    mod = f"models.{BACKBONE_MODULES[(model, width)]}"
    if model == "dcgan":
        branding = [(DcganEncoder, mod, "encoder"),
                    (DcganDecoder, mod, "decoder"),
                    (dcgan_conv, mod, "dcgan_conv"),
                    (dcgan_upconv, mod, "dcgan_upconv")]
    else:
        branding = [(VggEncoder, mod, "encoder"), (VggDecoder, mod, "decoder"),
                    (vgg_layer, mod, "vgg_layer")]
    branding.append((RefLSTM, "models.lstm", "lstm"))
    saved = [(cls, cls.__module__, cls.__qualname__) for cls, _, _ in branding]
    with _reference_shim():
        for cls, m, name in branding:
            cls.__module__, cls.__qualname__ = m, name
        try:
            yield
        finally:
            for cls, m, name in saved:
                cls.__module__, cls.__qualname__ = m, name


def save_reference_style_checkpoint(path: str, encoder, decoder,
                                    frame_predictor, gp_sd, lik_sd, opt):
    """torch.save a checkpoint in the reference's schema (train.py:380-388):
    whole modules, the GP and likelihood state_dicts, an empty
    gp_layer_optimizer and the `opt` namespace. Either package's importer
    reads it, whichever of the four backbones `encoder` is."""
    with _reference_identity(*_detect_backbone(encoder)):
        torch.save({"encoder": encoder, "decoder": decoder,
                    "frame_predictor": frame_predictor,
                    "likelihood": lik_sd, "gp_layer": gp_sd,
                    "gp_layer_optimizer": {}, "opt": opt}, path)


# ===========================================================================
# tensor-level converters
# ===========================================================================

def _np(t):
    return t.detach().cpu().numpy().astype(np.float32)


def t2j_conv(w):
    return _np(w).transpose(2, 3, 1, 0)


def t2j_convT(w):
    return np.ascontiguousarray(_np(w)[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))


def t2j_linear(w):
    return np.ascontiguousarray(_np(w).T)


def _assign(tparam, arr):
    with torch.no_grad():
        # np.array: a writable copy (the caller's array may be read-only)
        tparam.copy_(torch.from_numpy(np.array(arr, np.float32)))


def j2t_conv(tparam, w):
    _assign(tparam, np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def j2t_convT(tparam, w):
    _assign(tparam,
            np.asarray(w, np.float32).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def j2t_linear(tparam, w):
    _assign(tparam, np.asarray(w, np.float32).T)


# -- conv/BN block pairs ----------------------------------------------------

def _t2j_block(conv_m, bn_m, transpose: bool):
    wj = t2j_convT(conv_m.weight) if transpose else t2j_conv(conv_m.weight)
    params = {"conv": {"w": wj, "b": _np(conv_m.bias)},
              "bn": {"scale": _np(bn_m.weight), "bias": _np(bn_m.bias)}}
    stats = {"bn": {"mean": _np(bn_m.running_mean),
                    "var": _np(bn_m.running_var)}}
    return params, stats


def _j2t_block(params, stats, conv_m, bn_m, transpose: bool):
    (j2t_convT if transpose else j2t_conv)(conv_m.weight, params["conv"]["w"])
    _assign(conv_m.bias, params["conv"]["b"])
    _assign(bn_m.weight, params["bn"]["scale"])
    _assign(bn_m.bias, params["bn"]["bias"])
    _assign(bn_m.running_mean, stats["bn"]["mean"])
    _assign(bn_m.running_var, stats["bn"]["var"])


# ===========================================================================
# module-level converters (dcgan, vgg, lstm)
# ===========================================================================

def _dcgan_enc_modules(tmod):
    """((conv, bn), is_head) of c1..cN and the head, in order."""
    i = 1
    while hasattr(tmod, f"c{i + 1}"):
        blk = getattr(tmod, f"c{i}").main
        yield (blk[0], blk[1]), False
        i += 1
    head = getattr(tmod, f"c{i}")
    yield (head[0], head[1]), True


def dcgan_encoder_t2j(tmod) -> Tuple[Dict, Dict]:
    stages_p, stages_s, head = [], [], None
    for (conv, bn), is_head in _dcgan_enc_modules(tmod):
        p, s = _t2j_block(conv, bn, transpose=False)
        if is_head:
            head = (p, s)
        else:
            stages_p.append(p)
            stages_s.append(s)
    return ({"stages": stages_p, "head": head[0]},
            {"stages": stages_s, "head": head[1]})


def dcgan_encoder_j2t(params, stats, tmod):
    for i, ((conv, bn), is_head) in enumerate(_dcgan_enc_modules(tmod)):
        if is_head:
            _j2t_block(params["head"], stats["head"], conv, bn, False)
        else:
            _j2t_block(params["stages"][i], stats["stages"][i], conv, bn,
                       False)


def _dcgan_dec_modules(tmod):
    """The head (upc1), the stages (upc2..upc(N-1)), the final convT
    (upcN)."""
    head = tmod.upc1
    stages = []
    n = 2
    while hasattr(tmod, f"upc{n + 1}"):
        m = getattr(tmod, f"upc{n}").main
        stages.append((m[0], m[1]))
        n += 1
    final = getattr(tmod, f"upc{n}")[0]
    return (head[0], head[1]), stages, final


def dcgan_decoder_t2j(tmod) -> Tuple[Dict, Dict]:
    (hc, hb), stages, final = _dcgan_dec_modules(tmod)
    hp, hs = _t2j_block(hc, hb, transpose=True)
    sp, ss = [], []
    for conv, bn in stages:
        p, s = _t2j_block(conv, bn, transpose=True)
        sp.append(p)
        ss.append(s)
    params = {"head": hp, "stages": sp,
              "final": {"w": t2j_convT(final.weight), "b": _np(final.bias)}}
    return params, {"head": hs, "stages": ss}


def dcgan_decoder_j2t(params, stats, tmod):
    (hc, hb), stages, final = _dcgan_dec_modules(tmod)
    _j2t_block(params["head"], stats["head"], hc, hb, True)
    for i, (conv, bn) in enumerate(stages):
        _j2t_block(params["stages"][i], stats["stages"][i], conv, bn, True)
    j2t_convT(final.weight, params["final"]["w"])
    _assign(final.bias, params["final"]["b"])


def _vgg_enc_modules(tmod):
    """The (conv, bn) pairs of each group, then the head's."""
    i = 1
    groups = []
    while hasattr(tmod, f"c{i + 1}"):
        seq = getattr(tmod, f"c{i}")
        groups.append([(vl.main[0], vl.main[1]) for vl in seq])
        i += 1
    head = getattr(tmod, f"c{i}")
    return groups, (head[0], head[1])


def vgg_encoder_t2j(tmod) -> Tuple[Dict, Dict]:
    groups, (hc, hb) = _vgg_enc_modules(tmod)
    gp, gs = [], []
    for g in groups:
        ps = [_t2j_block(c, b, False) for c, b in g]
        gp.append([p for p, _ in ps])
        gs.append([s for _, s in ps])
    hp, hs = _t2j_block(hc, hb, False)
    return {"groups": gp, "head": hp}, {"groups": gs, "head": hs}


def vgg_encoder_j2t(params, stats, tmod):
    groups, (hc, hb) = _vgg_enc_modules(tmod)
    for gi, g in enumerate(groups):
        for bi, (c, b) in enumerate(g):
            _j2t_block(params["groups"][gi][bi], stats["groups"][gi][bi],
                       c, b, False)
    _j2t_block(params["head"], stats["head"], hc, hb, False)


def _vgg_dec_modules(tmod):
    head = tmod.upc1
    groups, final = [], None
    n = 2
    while hasattr(tmod, f"upc{n}"):
        blocks = []
        for child in getattr(tmod, f"upc{n}"):
            if isinstance(child, nn.ConvTranspose2d):
                final = child
            elif hasattr(child, "main"):       # vgg_layer
                blocks.append((child.main[0], child.main[1]))
        groups.append(blocks)
        n += 1
    return (head[0], head[1]), groups, final


def vgg_decoder_t2j(tmod) -> Tuple[Dict, Dict]:
    (hc, hb), groups, final = _vgg_dec_modules(tmod)
    hp, hs = _t2j_block(hc, hb, True)
    gp, gs = [], []
    for g in groups:
        ps = [_t2j_block(c, b, False) for c, b in g]
        gp.append([p for p, _ in ps])
        gs.append([s for _, s in ps])
    params = {"head": hp, "groups": gp,
              "final": {"w": t2j_convT(final.weight), "b": _np(final.bias)}}
    return params, {"head": hs, "groups": gs}


def vgg_decoder_j2t(params, stats, tmod):
    (hc, hb), groups, final = _vgg_dec_modules(tmod)
    _j2t_block(params["head"], stats["head"], hc, hb, True)
    for gi, g in enumerate(groups):
        for bi, (c, b) in enumerate(g):
            _j2t_block(params["groups"][gi][bi], stats["groups"][gi][bi],
                       c, b, False)
    j2t_convT(final.weight, params["final"]["w"])
    _assign(final.bias, params["final"]["b"])


def lstm_t2j(tmod) -> Dict:
    cells = []
    for cell in tmod.lstm:
        cells.append({"w_ih": t2j_linear(cell.weight_ih),
                      "w_hh": t2j_linear(cell.weight_hh),
                      "b_ih": _np(cell.bias_ih),
                      "b_hh": _np(cell.bias_hh)})
    return {
        "embed": {"w": t2j_linear(tmod.embed.weight),
                  "b": _np(tmod.embed.bias)},
        "cells": cells,
        "output": {"w": t2j_linear(tmod.output[0].weight),
                   "b": _np(tmod.output[0].bias)},
    }


def lstm_j2t(params, tmod):
    j2t_linear(tmod.embed.weight, params["embed"]["w"])
    _assign(tmod.embed.bias, params["embed"]["b"])
    for cell, cp in zip(tmod.lstm, params["cells"], strict=True):
        j2t_linear(cell.weight_ih, cp["w_ih"])
        j2t_linear(cell.weight_hh, cp["w_hh"])
        _assign(cell.bias_ih, cp["b_ih"])
        _assign(cell.bias_hh, cp["b_hh"])
    j2t_linear(tmod.output[0].weight, params["output"]["w"])
    _assign(tmod.output[0].bias, params["output"]["b"])


# ===========================================================================
# GP state_dicts ⇄ SVGP params (gpytorch whitened strategy ≙ models/gp.py)
# ===========================================================================

def _sd_find(sd, *suffixes):
    for suf in suffixes:
        for k, v in sd.items():
            if k.endswith(suf):
                return _np(v)
    raise KeyError(f"none of {suffixes} in {list(sd)}")


def gp_state_dicts_t2j(gp_sd, lik_sd, num_tasks: int) -> Tuple[Dict, Dict]:
    """gpytorch GPRegressionLayer1 + GaussianLikelihood state_dicts →
    (gp params, likelihood params) trees (models/gp.py layout)."""
    d = num_tasks
    z = _sd_find(gp_sd, "inducing_points").reshape(d, -1, 1)
    m = z.shape[1]
    gp = {
        "z": z,
        "var_mean": _sd_find(gp_sd, "variational_mean").reshape(d, m),
        "var_chol": np.tril(
            _sd_find(gp_sd, "chol_variational_covar").reshape(d, m, m)),
        "mean_const": _sd_find(gp_sd, "mean_module.constant").reshape(d),
        "raw_outputscale": _sd_find(gp_sd, "raw_outputscale").reshape(d),
        "raw_lengthscale": _sd_find(gp_sd, "raw_lengthscale").reshape(d),
    }
    lik = {"raw_noise": _sd_find(lik_sd, "raw_noise").reshape(d)}
    return gp, lik


def gp_state_dicts_j2t(gp: Dict, lik: Dict) -> Tuple[Dict, Dict]:
    """The inverse of `gp_state_dicts_t2j`: (gp, likelihood) trees →
    (GP layer, likelihood) state_dicts under gpytorch's names and shapes
    for D tasks and M inducing points."""
    def t(a, *shape):
        return torch.from_numpy(np.array(a, np.float32).reshape(shape))
    d, m = np.shape(gp["var_mean"])
    vd = "variational_strategy.variational_distribution."
    gp_sd = {
        "variational_strategy.inducing_points": t(gp["z"], d, m, 1),
        vd + "variational_mean": t(gp["var_mean"], d, m),
        vd + "chol_variational_covar": t(gp["var_chol"], d, m, m),
        "mean_module.constant": t(gp["mean_const"], d, 1),
        "covar_module.raw_outputscale": t(gp["raw_outputscale"], d),
        "covar_module.base_kernel.raw_lengthscale": t(
            gp["raw_lengthscale"], d, 1, 1),
    }
    return gp_sd, {"noise_covar.raw_noise": t(lik["raw_noise"], d, 1)}


# ===========================================================================
# reference modules from a shared tree
# ===========================================================================

def reference_modules(params: Dict, stats: Dict, cfg: DVGConfig):
    """(encoder, decoder, frame_predictor) of the reference's architecture
    for cfg's backbone, on the CPU, carrying the shared (params, stats)
    tree's weights (`convert.params_to_jax` of a port model gives one)."""
    if cfg.model == "dcgan":
        enc_cls, dec_cls = DcganEncoder, DcganDecoder
        enc_j2t, dec_j2t = dcgan_encoder_j2t, dcgan_decoder_j2t
    else:
        enc_cls, dec_cls = VggEncoder, VggDecoder
        enc_j2t, dec_j2t = vgg_encoder_j2t, vgg_decoder_j2t
    enc = enc_cls(cfg.g_dim, cfg.channels, cfg.image_width)
    dec = dec_cls(cfg.g_dim, cfg.channels, cfg.image_width)
    fp = RefLSTM(cfg.g_dim, cfg.g_dim, cfg.rnn_size, cfg.predictor_rnn_layers,
                 cfg.batch_size)
    enc_j2t(params["encoder"], stats["encoder"], enc)
    dec_j2t(params["decoder"], stats["decoder"], dec)
    lstm_j2t(params["frame_predictor"], fp)
    return enc, dec, fp


# ===========================================================================
# whole-checkpoint import
# ===========================================================================

def _detect_backbone(enc) -> Tuple[str, int]:
    model = "vgg" if hasattr(enc, "mp") else "dcgan"
    width = 128 if hasattr(enc, "c6") else 64
    return model, width


def config_from_opt(opt) -> DVGConfig:
    return DVGConfig.from_dict(dict(vars(opt)))


def _check_shapes(native, imported, path: str = "") -> None:
    """Exact shape equality leaf for leaf (broadcast compatibility would let
    a stray singleton dimension through to fail opaquely in a rollout)."""
    if isinstance(native, dict):
        if set(native) != set(imported):
            raise ValueError(f"imported tree at {path or '/'} has "
                             f"{sorted(imported)}, native {sorted(native)}")
        for k in native:
            _check_shapes(native[k], imported[k], f"{path}/{k}")
    elif isinstance(native, list):
        if len(native) != len(imported):
            raise ValueError(f"imported tree at {path} has {len(imported)} "
                             f"entries, native {len(native)}")
        for i, (a, b) in enumerate(zip(native, imported)):
            _check_shapes(a, b, f"{path}/{i}")
    elif np.shape(native) != np.shape(imported):
        raise ValueError(f"imported tensor {path} shape {np.shape(imported)} "
                         f"!= native {np.shape(native)}")


def import_checkpoint(pth_path: str, out_path: str, device="cuda") -> str:
    """Convert a reference model.pth (train.py:380-388 schema) into a
    model.ckpt the port's and `dvg_tpu`'s CLIs run: a whole TrainState with
    fresh optimizers and step 0, built on `device` (default the card,
    raising without one). `out_path` is a directory or a .ckpt file.
    Returns the written path."""
    dev = resolve_device(device)
    ck = load_reference_checkpoint(pth_path)
    enc, dec, fp = ck["encoder"], ck["decoder"], ck["frame_predictor"]
    model_name, width = _detect_backbone(enc)
    gp_p, lik_p = gp_state_dicts_t2j(
        ck["gp_layer"], ck["likelihood"],
        int(getattr(ck["opt"], "g_dim", 90)))
    cfg = config_from_opt(ck["opt"]).replace(
        model=model_name, image_width=width,
        # the reference's opt has no inducing-point field; the saved
        # variational state has
        num_inducing_points=int(gp_p["z"].shape[1]))
    if model_name == "dcgan":
        enc_p, enc_s = dcgan_encoder_t2j(enc)
        dec_p, dec_s = dcgan_decoder_t2j(dec)
    else:
        enc_p, enc_s = vgg_encoder_t2j(enc)
        dec_p, dec_s = vgg_decoder_t2j(dec)
    params = {"encoder": enc_p, "decoder": dec_p,
              "frame_predictor": lstm_t2j(fp),
              "gp": gp_p, "likelihood": lik_p}
    stats = {"encoder": enc_s, "decoder": dec_s}

    # shape-check the transplant against a native init, then adopt it
    state = init_train_state(cfg, device=dev)
    native_p, native_s = params_to_jax(state.model.state_dict(), cfg)
    _check_shapes(native_p, params)
    _check_shapes(native_s, stats)
    state.model.load_state_dict(params_from_jax(params, stats, cfg))
    return save_train_state(out_path, cfg, state)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert a reference DVG model.pth into a model.ckpt "
                    "(the dvg_tpu format, which both packages read)")
    ap.add_argument("pth", help="reference checkpoint (train.py:380-388)")
    ap.add_argument("out", help="output directory or .ckpt path")
    ap.add_argument("--device", default="cuda",
                    help="torch device the TrainState is built on")
    args = ap.parse_args(argv)
    print("wrote", import_checkpoint(args.pth, args.out, device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
