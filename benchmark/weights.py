"""Seeded weights of a configuration, made on the device from `--seed`.

`layout(spec)` lists every tensor of a DVG model (the names both the
program's `state_dict` and the reference use) with its shape and its role;
`make(spec, law, seed, device)` fills them from one `torch.Generator` on
the device in three large draws (normal, uniform, uniform), sliced per
tensor, in f32, the type the program keeps its master weights in.

Laws:
  * "init": the recipe's initial weights (conv and linear N(0, 0.02),
    biases 0, BN scale N(1, 0.02), LSTM cells U(±1/√H); the GP's inducing
    points U[0, 1], m = 0, L_S = I, raw hyperparameters 0). Training starts
    here.
  * "unit_gain": conv and linear weights N(0, gain²/fan-in) (gain
    √(2/(1 + 0.2²)) before a LeakyReLU, else 1) and a trained-looking GP
    (spread inducing points, m ~ N(0, 0.5), L_S off the identity, a
    shorter lengthscale and a smaller noise). At the init law's std the
    latent barely reaches the frames, so the eval's GP draws and LSTM would
    be covered by no comparison; here they move every frame.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NF = 64
LEAKY_GAIN2 = 2.0 / (1.0 + 0.2 ** 2)

# (name, shape, role, fan-in, gain²); roles: w (conv/linear weight),
# b (bias), bn_w, bn_b, bn_rm, bn_rv, bn_n, cell (LSTM cell tensor),
# gp.* (the GP's own)
Entry = Tuple[str, Tuple[int, ...], str, int, float]


def _conv(out: List[Entry], name: str, cin: int, cout: int, k: int,
          transposed: bool, fan: int, gain2: float, bn: bool) -> None:
    wname = f"{name}.conv" if bn else name
    shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
    out.append((f"{wname}.weight", shape, "w", fan, gain2))
    out.append((f"{wname}.bias", (cout,), "b", 0, 0.0))
    if bn:
        for suffix, role in (("weight", "bn_w"), ("bias", "bn_b"),
                             ("running_mean", "bn_rm"),
                             ("running_var", "bn_rv")):
            out.append((f"{name}.bn.{suffix}", (cout,), role, 0, 0.0))
        out.append((f"{name}.bn.num_batches_tracked", (), "bn_n", 0, 0.0))


def layout(spec: Dict) -> List[Entry]:
    """Every tensor of the model `spec` describes (its `model`,
    `image_width`, `channels`, `g_dim`, `rnn_size`, `predictor_rnn_layers`,
    `num_inducing_points`)."""
    nc, g, w = spec["channels"], spec["g_dim"], spec["image_width"]
    h, layers, m = (spec["rnn_size"], spec["predictor_rnn_layers"],
                    spec["num_inducing_points"])
    out: List[Entry] = []
    lg = LEAKY_GAIN2
    if spec["model"] == "dcgan":
        enc = [(nc, NF), (NF, NF * 2), (NF * 2, NF * 4), (NF * 4, NF * 8)]
        dec = [(NF * 16, NF * 4), (NF * 8, NF * 2), (NF * 4, NF)]
        if w == 128:
            enc.append((NF * 8, NF * 8))
            dec = [(NF * 16, NF * 8)] + [(NF * 16, NF * 4)] + dec[1:]
        for i, (ci, co) in enumerate(enc):
            _conv(out, f"encoder.stages.{i}", ci, co, 4, False, ci * 16, lg,
                  True)
        _conv(out, "encoder.head", NF * 8, g, 4, False, NF * 8 * 16, 1.0,
              True)
        _conv(out, "decoder.head", g, NF * 8, 4, True, g, lg, True)
        for i, (ci, co) in enumerate(dec):
            _conv(out, f"decoder.stages.{i}", ci, co, 4, True, ci * 4, lg,
                  True)
        _conv(out, "decoder.final", NF * 2, nc, 4, True, NF * 2 * 4, 1.0,
              False)
    elif spec["model"] == "vgg":
        enc = [[nc, 64, 64], [64, 128, 128], [128, 256, 256, 256],
               [256, 512, 512, 512]]
        dec = [[1024, 512, 512, 256], [512, 256, 256, 128], [256, 128, 64],
               [128, 64]]
        if w == 128:
            enc.append([512, 512, 512, 512])
            dec = [[1024, 512, 512, 512], [1024, 512, 512, 256]] + dec[1:]
        for i, chain in enumerate(enc):
            for j, (ci, co) in enumerate(zip(chain[:-1], chain[1:])):
                _conv(out, f"encoder.groups.{i}.{j}", ci, co, 3, False,
                      ci * 9, lg, True)
        _conv(out, "encoder.head", 512, g, 4, False, 512 * 16, 1.0, True)
        _conv(out, "decoder.head", g, 512, 4, True, g, lg, True)
        for i, chain in enumerate(dec):
            for j, (ci, co) in enumerate(zip(chain[:-1], chain[1:])):
                _conv(out, f"decoder.groups.{i}.{j}", ci, co, 3, False,
                      ci * 9, lg, True)
        _conv(out, "decoder.final", 64, nc, 3, True, 64 * 9, 1.0, False)
    else:
        raise ValueError(f"unknown backbone {spec['model']!r}")
    fp = "frame_predictor"
    out += [(f"{fp}.embed.weight", (h, g), "w", g, 1.0),
            (f"{fp}.embed.bias", (h,), "b", 0, 0.0)]
    for i in range(layers):
        for suffix, shape in (("weight_ih", (4 * h, h)),
                              ("weight_hh", (4 * h, h)),
                              ("bias_ih", (4 * h,)), ("bias_hh", (4 * h,))):
            out.append((f"{fp}.cells.{i}.{suffix}", shape, "cell", h, 0.0))
    out += [(f"{fp}.output.weight", (g, h), "w", h, 1.0),
            (f"{fp}.output.bias", (g,), "b", 0, 0.0)]
    out += [("gp.z", (g, m, 1), "gp.z", 0, 0.0),
            ("gp.var_mean", (g, m), "gp.var_mean", 0, 0.0),
            ("gp.var_chol", (g, m, m), "gp.var_chol", 0, 0.0),
            ("gp.mean_const", (g,), "gp.zero", 0, 0.0),
            ("gp.raw_outputscale", (g,), "gp.zero", 0, 0.0),
            ("gp.raw_lengthscale", (g,), "gp.lengthscale", 0, 0.0),
            ("likelihood.raw_noise", (g,), "gp.noise", 0, 0.0)]
    return out


def make(spec: Dict, law: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights of `spec` under `law` on `device`, f32."""
    if law not in ("init", "unit_gain"):
        raise ValueError(f"unknown weight law {law!r}")
    entries = layout(spec)
    sizes = [math.prod(shape) for _, shape, *_ in entries]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    uniform2 = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, role, fan, gain2), n in zip(entries, sizes):
        nz, un, u2 = (a[at:at + n].view(shape)
                      for a in (normal, uniform, uniform2))
        at += n
        out[name] = _fill(role, shape, fan, gain2, nz, un, u2, law, device)
    return out


def _fill(role, shape, fan, gain2, nz, un, u2, law, device):
    unit = law == "unit_gain"
    if role == "w":
        return nz * (math.sqrt(gain2 / fan) if unit else 0.02)
    if role in ("b", "bn_b", "bn_rm", "gp.zero"):
        return torch.zeros(shape, device=device)
    if role == "bn_w":
        return 1.0 + 0.02 * nz
    if role == "bn_rv":
        return torch.ones(shape, device=device)
    if role == "bn_n":
        return torch.zeros(shape, dtype=torch.int64, device=device)
    if role == "cell":
        bound = 1.0 / math.sqrt(fan)
        return (2.0 * un - 1.0) * bound
    d, m = shape[0], (shape[1] if len(shape) > 1 else 0)
    if role == "gp.z":
        if not unit:
            return un.clone()
        grid = torch.linspace(-1.0, 1.0, m, device=device)
        return grid[None, :, None] + 0.06 * (un - 0.5)
    if role == "gp.var_mean":
        return 0.5 * nz if unit else torch.zeros(shape, device=device)
    if role == "gp.var_chol":
        eye = torch.eye(m, device=device).expand(shape)
        if not unit:
            return eye.clone()
        return eye * (0.2 + 0.4 * un) + torch.tril(0.1 * nz, -1)
    if role == "gp.lengthscale":
        return torch.full(shape, -1.2 if unit else 0.0, device=device)
    if role == "gp.noise":
        return torch.full(shape, -2.0 if unit else 0.0, device=device)
    raise ValueError(f"unknown role {role!r}")
