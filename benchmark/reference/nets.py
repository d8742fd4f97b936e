"""DVG's networks as plain functions of a weight dict, NCHW inside.

The weight dict `P` maps the names the benchmark's seeded weights use
(`encoder.stages.0.conv.weight`, `frame_predictor.cells.1.weight_hh`,
`gp.var_chol`, ...) to f32 tensors; the structure of each backbone is read
from those names. `Ops` holds the three contractions every layer uses, so
the control (`quant.FP8Ops`) can run the same networks with fp8 operands.

  * DCGAN (shgaurav1/DVG models/dcgan_64.py, dcgan_128.py): stride-2 4×4
    conv + BN + LeakyReLU(0.2) stages, a 4×4 valid conv + BN + tanh head;
    the decoder a 4×4 transposed-conv head, stride-2 transposed-conv
    stages on cat(d, skip), a final transposed conv with tanh at 64 px
    and sigmoid at 128 px.
  * VGG (models/vgg_64.py, vgg_128.py): groups of 3×3 conv + BN +
    LeakyReLU with a 2×2 max-pool between them, the pre-pool group
    outputs the skips; the decoder upsamples ×2 (nearest) before each
    group, which reads cat(up, skip); a final 3×3 transposed conv and
    sigmoid.
  * the latent LSTM (models/lstm.py): Linear embed, stacked LSTM cells
    (gate order i, f, g, o), Linear + tanh.
  * the g_dim-task whitened SVGP with a Gaussian likelihood: predictive
    mean and variance by a Cholesky of K_ZZ + 1e-4·I and a triangular
    solve, its ELBO, and its marginal sample.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
SLOPE = 0.2
JITTER = 1e-4
NOISE_FLOOR = 1e-4

Weights = Dict[str, torch.Tensor]
# (block name, conv output) -> normalized output
BatchNorm = Callable[[str, torch.Tensor], torch.Tensor]


class Ops:
    """Plain float32 contractions."""

    def conv(self, x, w, b, stride, pad):
        return F.conv2d(x, w, b, stride, pad)

    def conv_t(self, x, w, b, stride, pad):
        return F.conv_transpose2d(x, w, b, stride, pad)

    def linear(self, x, w, b):
        return F.linear(x, w, b)

    def gp_round(self, x):
        """A generation's GP tensor as the configuration's compute precision
        holds it: here f32, unchanged."""
        return x


def eval_bn(P: Weights) -> BatchNorm:
    """BatchNorm with the running statistics."""
    def bn(name: str, y: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(y, P[f"{name}.bn.running_mean"],
                            P[f"{name}.bn.running_var"],
                            P[f"{name}.bn.weight"], P[f"{name}.bn.bias"],
                            training=False, eps=BN_EPS)
    return bn


class TrainBN:
    """BatchNorm with the batch's statistics; records each call's (block
    name, batch mean, unbiased variance) in call order."""

    def __init__(self, P: Weights):
        self.P = P
        self.calls: List[Tuple[str, torch.Tensor, torch.Tensor]] = []

    def __call__(self, name: str, y: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
        n = y.shape[0] * y.shape[2] * y.shape[3]
        self.calls.append((name, mean.detach(),
                           var.detach() * (n / max(n - 1, 1))))
        out = (y - mean[None, :, None, None]) * torch.rsqrt(
            var + BN_EPS)[None, :, None, None]
        return (out * self.P[f"{name}.bn.weight"][None, :, None, None]
                + self.P[f"{name}.bn.bias"][None, :, None, None])


def fold_running(P: Weights, calls) -> None:
    """The running statistics after each recorded call in turn:
    r ← (1 − m)·r + m·s."""
    with torch.no_grad():
        for name, mean, var in calls:
            for key, s in (("running_mean", mean), ("running_var", var)):
                r = P[f"{name}.bn.{key}"]
                r.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * s)


def _count(P: Weights, prefix: str) -> int:
    idx = {int(k[len(prefix):].split(".")[0]) for k in P
           if k.startswith(prefix)}
    return max(idx) + 1 if idx else 0


def _lrelu(x):
    return F.leaky_relu(x, SLOPE)


def _block(P, name, x, ops, bn, stride, pad, transposed=False):
    w, b = P[f"{name}.conv.weight"], P[f"{name}.conv.bias"]
    y = (ops.conv_t if transposed else ops.conv)(x, w, b, stride, pad)
    return bn(name, y)


def is_vgg(P: Weights) -> bool:
    return any(k.startswith("encoder.groups.") for k in P)


def encode(P: Weights, x: torch.Tensor, ops: Ops, bn: BatchNorm
           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x (B, H, W, C) → (h (B, g_dim), skips NCHW)."""
    h = x.permute(0, 3, 1, 2)
    skips = []
    if is_vgg(P):
        for i in range(_count(P, "encoder.groups.")):
            if i:
                h = F.max_pool2d(h, 2, 2)
            for j in range(_count(P, f"encoder.groups.{i}.")):
                h = _lrelu(_block(P, f"encoder.groups.{i}.{j}", h, ops, bn,
                                  1, 1))
            skips.append(h)
        h = F.max_pool2d(h, 2, 2)
    else:
        for i in range(_count(P, "encoder.stages.")):
            h = _lrelu(_block(P, f"encoder.stages.{i}", h, ops, bn, 2, 1))
            skips.append(h)
    h = torch.tanh(_block(P, "encoder.head", h, ops, bn, 1, 0))
    return h.reshape(h.shape[0], -1), skips


def decode(P: Weights, vec: torch.Tensor, skips: List[torch.Tensor],
           ops: Ops, bn: BatchNorm) -> torch.Tensor:
    """(vec (B, g_dim), skips NCHW) → frames (B, H, W, C)."""
    d = _lrelu(_block(P, "decoder.head", vec[:, :, None, None], ops, bn, 1,
                      0, transposed=True))
    fw, fb = P["decoder.final.weight"], P["decoder.final.bias"]
    if is_vgg(P):
        for i, skip in enumerate(reversed(skips)):
            d = torch.cat([F.interpolate(d, scale_factor=2.0,
                                         mode="nearest"), skip], dim=1)
            for j in range(_count(P, f"decoder.groups.{i}.")):
                d = _lrelu(_block(P, f"decoder.groups.{i}.{j}", d, ops, bn,
                                  1, 1))
        out = torch.sigmoid(ops.conv_t(d, fw, fb, 1, 1))
    else:
        n = _count(P, "decoder.stages.")
        rev = list(reversed(skips))
        for i in range(n):
            d = _lrelu(_block(P, f"decoder.stages.{i}",
                              torch.cat([d, rev[i]], dim=1), ops, bn, 2, 1,
                              transposed=True))
        out = ops.conv_t(torch.cat([d, skips[0]], dim=1), fw, fb, 2, 1)
        out = torch.tanh(out) if n == 3 else torch.sigmoid(out)
    return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the latent LSTM
# ---------------------------------------------------------------------------

def lstm_layers(P: Weights) -> int:
    return _count(P, "frame_predictor.cells.")


def lstm_zero(P: Weights, batch: int, device) -> Tuple[list, list]:
    hsz = P["frame_predictor.embed.weight"].shape[0]
    z = [torch.zeros(batch, hsz, device=device) for _ in range(lstm_layers(P))]
    return list(z), list(z)


def lstm_step(P: Weights, hidden, x: torch.Tensor, ops: Ops):
    """One step: x (B, g_dim) → (tanh(output), new hidden)."""
    hs, cs = hidden
    e = ops.linear(x, P["frame_predictor.embed.weight"],
                   P["frame_predictor.embed.bias"])
    new_h, new_c = [], []
    for layer in range(len(hs)):
        pre = f"frame_predictor.cells.{layer}."
        gates = (ops.linear(e, P[pre + "weight_ih"], P[pre + "bias_ih"])
                 + ops.linear(hs[layer], P[pre + "weight_hh"],
                              P[pre + "bias_hh"]))
        i, f, g, o = gates.chunk(4, dim=1)
        c = torch.sigmoid(f) * cs[layer] + torch.sigmoid(i) * torch.tanh(g)
        e = torch.sigmoid(o) * torch.tanh(c)
        new_h.append(e)
        new_c.append(c)
    out = torch.tanh(ops.linear(e, P["frame_predictor.output.weight"],
                                P["frame_predictor.output.bias"]))
    return out, (new_h, new_c)


# ---------------------------------------------------------------------------
# the SVGP
# ---------------------------------------------------------------------------

def _rbf(os_, ls, a, b):
    """a (D, N), b (D, M) → (D, N, M)."""
    d = (a[:, :, None] - b[:, None, :]) / ls[:, None, None]
    return os_[:, None, None] * torch.exp(-0.5 * d * d)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def gp_predict(P: Weights, x: torch.Tensor, r=_same
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive mean and variance of f (noise not included) at x (D, B):
    mean = μ + K_XZ L⁻ᵀ m, var = k(x, x) − ‖L⁻¹K_ZX‖² + ‖L_Sᵀ L⁻¹K_ZX‖²,
    L = chol(K_ZZ + 1e-4·I); the variance clamped at 1e-10. `r` rounds
    every intermediate (the control's precision; f32: unchanged)."""
    os_ = F.softplus(P["gp.raw_outputscale"])
    ls = F.softplus(P["gp.raw_lengthscale"])
    z = P["gp.z"][..., 0]
    m = z.shape[1]
    kzz = _rbf(os_, ls, z, z) + JITTER * torch.eye(m, device=z.device)
    chol = r(torch.linalg.cholesky(kzz))
    kzx = r(_rbf(os_, ls, z, x))                           # (D, M, B)
    a = r(torch.linalg.solve_triangular(chol, kzx, upper=False))
    mean = r(P["gp.mean_const"][:, None] + r((a * P["gp.var_mean"][:, :, None]
                                              ).sum(1)))
    ls_a = r(torch.tril(P["gp.var_chol"]).transpose(1, 2) @ a)
    var = r(os_[:, None] - r((a * a).sum(1)) + r((ls_a * ls_a).sum(1)))
    return mean, torch.clamp(var, min=1e-10)


def gp_noise(P: Weights) -> torch.Tensor:
    return F.softplus(P["likelihood.raw_noise"]) + NOISE_FLOOR


def gp_sample(P: Weights, h: torch.Tensor, eps: torch.Tensor,
              ops: Ops) -> torch.Tensor:
    """A marginal sample of likelihood(gp(h)) for h, eps (B, D) → (B, D)."""
    r = ops.gp_round
    mean, var = gp_predict(P, r(h).T, r)
    return r(mean + torch.sqrt(var + gp_noise(P)[:, None]) * eps.T).T


def gp_kl(P: Weights) -> torch.Tensor:
    m = P["gp.var_mean"]
    l_s = torch.tril(P["gp.var_chol"])
    logdet = 2.0 * torch.log(torch.abs(torch.diagonal(
        l_s, dim1=-2, dim2=-1)) + 1e-20).sum(-1)
    return 0.5 * ((l_s * l_s).sum((-2, -1)) + (m * m).sum(-1) - m.shape[-1]
                  - logdet)


def gp_elbo(P: Weights, x: torch.Tensor, y: torch.Tensor, num_data: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-task ELBO (D,), predictive mean (D, B)) of targets y (D, B) at
    inputs x (D, B): the mean over the B points of E_q[log N(y | f, σ²)]
    minus KL(q(v) ‖ N(0, I)) / num_data."""
    mean, var = gp_predict(P, x)
    noise = gp_noise(P)[:, None]
    ll = -0.5 * (math.log(2.0 * math.pi) + torch.log(noise)
                 + ((y - mean) ** 2 + var) / noise)
    return ll.mean(-1) - gp_kl(P) / num_data, mean
