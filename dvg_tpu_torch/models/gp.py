"""Inference half of the batched whitened SVGP (counterpart of
`dvg_tpu/models/gp.py`: `gp_init`, `likelihood_init`, `_rbf`, `_kzz_chol`,
`GPCache`/`build_cache`, `cached_mean_var`, `cached_rsample`).

`num_tasks` (= g_dim) independent 1-D GPs, each with `num_inducing`
inducing locations, a constant mean, a scaled RBF kernel and a whitened
variational q(v) = N(m, L_S L_Sᵀ). Inputs are in task layout: (D, B, 1).

With L = chol(K_ZZ + jitter·I) and W = L⁻ᵀ, the cache holds
  v1 = W m,  v2 = W L_S,
so a rollout step needs one (D, B, M) kernel row and three small matmuls:
  mean = μ + K_XZ v1,  var = k(x,x) − ‖K_XZ W‖² + ‖K_XZ v2‖².
The Cholesky and the triangular inverse run in f32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

JITTER = 1e-4
NOISE_FLOOR = 1e-4


class SVGP(nn.Module):
    def __init__(self, num_tasks: int, num_inducing: int):
        super().__init__()
        d, m = num_tasks, num_inducing
        self.z = nn.Parameter(torch.empty(d, m, 1))
        self.var_mean = nn.Parameter(torch.empty(d, m))
        self.var_chol = nn.Parameter(torch.empty(d, m, m))
        self.mean_const = nn.Parameter(torch.empty(d))
        self.raw_outputscale = nn.Parameter(torch.empty(d))
        self.raw_lengthscale = nn.Parameter(torch.empty(d))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Inducing locations U[0, 1]; m = 0, L_S = I; raw params 0."""
        self.z.uniform_(0.0, 1.0, generator=generator)
        self.var_mean.zero_()
        self.var_chol.copy_(torch.eye(self.var_chol.shape[-1]).expand_as(
            self.var_chol))
        self.mean_const.zero_()
        self.raw_outputscale.zero_()
        self.raw_lengthscale.zero_()


class GaussianLikelihood(nn.Module):
    """Per-task noise σ² = softplus(raw) + 1e-4."""

    def __init__(self, num_tasks: int):
        super().__init__()
        self.raw_noise = nn.Parameter(torch.empty(num_tasks))

    @torch.no_grad()
    def init(self) -> None:
        self.raw_noise.zero_()

    def noise_variance(self) -> torch.Tensor:
        return F.softplus(self.raw_noise) + NOISE_FLOOR


def rbf(outputscale: torch.Tensor, lengthscale: torch.Tensor,
        x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Scaled RBF from (D,) hyperparameters. x1 (D,N,1), x2 (D,M,1) →
    (D,N,M)."""
    diff = x1[..., :, 0][..., :, None] - x2[..., :, 0][..., None, :]
    sq = (diff / lengthscale[:, None, None]) ** 2
    return outputscale[:, None, None] * torch.exp(-0.5 * sq)


def kzz_chol(gp: SVGP) -> torch.Tensor:
    z = gp.z.float()
    kzz = rbf(F.softplus(gp.raw_outputscale.float()),
              F.softplus(gp.raw_lengthscale.float()), z, z)
    eye = torch.eye(z.shape[1], dtype=kzz.dtype, device=kzz.device)
    return torch.linalg.cholesky(kzz + JITTER * eye)


class GPCache(NamedTuple):
    w: torch.Tensor           # (D, M, M)  L⁻ᵀ
    v1: torch.Tensor          # (D, M)
    v2: torch.Tensor          # (D, M, M)
    z: torch.Tensor           # (D, M, 1)
    mean_const: torch.Tensor  # (D,)
    lengthscale: torch.Tensor  # (D,)
    outputscale: torch.Tensor  # (D,)
    noise: torch.Tensor       # (D,)

    def to(self, dtype: torch.dtype) -> "GPCache":
        return GPCache(*(t.to(dtype) for t in self))


def build_cache(gp: SVGP, lik: GaussianLikelihood) -> GPCache:
    """Cache of the frozen GP, in f32 whatever the parameters' dtype."""
    l_k = kzz_chol(gp)
    eye = torch.eye(l_k.shape[-1], dtype=l_k.dtype,
                    device=l_k.device).expand_as(l_k)
    w = torch.linalg.solve_triangular(l_k, eye, upper=False).transpose(1, 2)
    v1 = torch.einsum("dmn,dn->dm", w, gp.var_mean.float())
    v2 = torch.einsum("dmn,dnk->dmk", w, torch.tril(gp.var_chol.float()))
    return GPCache(
        w=w, v1=v1, v2=v2, z=gp.z.float(),
        mean_const=gp.mean_const.float(),
        lengthscale=F.softplus(gp.raw_lengthscale.float()),
        outputscale=F.softplus(gp.raw_outputscale.float()),
        noise=lik.noise_variance().float())


def cached_mean_var(cache: GPCache, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (D, B, 1) → (mean (D, B), variance of f (D, B))."""
    kxz = rbf(cache.outputscale, cache.lengthscale, x, cache.z)  # (D,B,M)
    a = torch.bmm(kxz, cache.w)
    mean = cache.mean_const[:, None] + torch.einsum("dbm,dm->db", kxz,
                                                    cache.v1)
    a_ls = torch.bmm(kxz, cache.v2)
    var = (cache.outputscale[:, None]
           - torch.sum(a * a, dim=-1) + torch.sum(a_ls * a_ls, dim=-1))
    return mean, torch.clamp(var, min=1e-10)


def cached_rsample(cache: GPCache, x: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """Marginal reparameterized sample of likelihood(gp(x)):
    mean + √(var + σ²)·eps, with eps (D, B) in task layout given by the
    caller (the JAX package derives it from fold_in(key, row) per row)."""
    mean, var = cached_mean_var(cache, x)
    return mean + torch.sqrt(var + cache.noise[:, None]) * eps
