"""The batched whitened SVGP (counterpart of `dvg_tpu/models/gp.py`:
`gp_init`, `likelihood_init`, `_rbf`, `_kzz_chol`, the differentiable
`posterior`, `kl_divergence`, `expected_log_prob` and `elbo` that training
takes gradients through; the library API on the raw parameters,
`rbf_cross`, `kernel_diag`, `predictive_variance`, `posterior_full_cov`
and `rsample`; and `GPCache`/`build_cache`, `cached_mean_var`,
`cached_rsample` for the rollouts).

`num_tasks` (= g_dim) independent 1-D GPs, each with `num_inducing`
inducing locations, a constant mean, a scaled RBF kernel and a whitened
variational q(v) = N(m, L_S L_Sᵀ). Inputs are in task layout: (D, B, 1).

With L = chol(K_ZZ + jitter·I) and W = L⁻ᵀ, the cache holds
  v1 = W m,  v2 = W L_S,
so a rollout step needs one (D, B, M) kernel row and three small matmuls:
  mean = μ + K_XZ v1,  var = k(x,x) − ‖K_XZ W‖² + ‖K_XZ v2‖².
The Cholesky, the triangular solves and the ELBO run in at least f32 (f64
parameters stay f64).

Every Cholesky here (`_chol`) follows `jnp.linalg.cholesky`'s failure law,
decided on the device: a matrix that is not positive definite factors to
NaN on and below the diagonal and 0 above it, and nothing is read back to
the host, so the callers' work stays queued on the card. A failed factor
shows as a non-finite loss or NaN outputs, as in `dvg_tpu`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dvg_tpu_torch.models.layers import acc_dtype, f32up

JITTER = 1e-4
NOISE_FLOOR = 1e-4
LOG_2PI = math.log(2.0 * math.pi)


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


def rbf_cross(gp: SVGP, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The GP's scaled RBF cross-covariance, in the inputs' dtype. x1
    (D,N,1), x2 (D,M,1) → (D,N,M)."""
    return rbf(F.softplus(gp.raw_outputscale.to(x1.dtype)),
               F.softplus(gp.raw_lengthscale.to(x1.dtype)), x1, x2)


def kernel_diag(gp: SVGP, n: int) -> torch.Tensor:
    """k(x, x) of the scaled RBF, the outputscale whatever x: (D, n)."""
    os_ = F.softplus(gp.raw_outputscale)
    return os_[:, None].expand(os_.shape[0], n)


def _chol(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of `a` (..., n, n), with no host
    check: a member that is not positive definite comes back NaN on and
    below the diagonal and 0 above it (`jnp.linalg.cholesky`'s law), chosen
    on the device. A positive definite member's factor, and its gradient,
    are `torch.linalg.cholesky`'s bit for bit."""
    l, info = torch.linalg.cholesky_ex(a, check_errors=False)
    return torch.where((info != 0)[..., None, None], math.nan, l).tril()


def kzz_chol(gp: SVGP, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """chol(K_ZZ + jitter·I) in `dtype` (default: the parameters', at least
    f32). A task whose K_ZZ is not positive definite factors to NaN on and
    below the diagonal, never to a host check (`_chol`), as in `dvg_tpu`."""
    dt = dtype or acc_dtype(gp.z.dtype)
    z = gp.z.to(dt)
    kzz = rbf_cross(gp, z, z)
    eye = torch.eye(z.shape[1], dtype=dt, device=kzz.device)
    return _chol(kzz + JITTER * eye)


# ---------------------------------------------------------------------------
# differentiable predictive posterior and ELBO (training)
# ---------------------------------------------------------------------------

class GPPosterior(NamedTuple):
    mean: torch.Tensor        # (..., D, B)
    var: torch.Tensor         # (..., D, B), noise not included


def _predictive(gp: SVGP, x: torch.Tensor, dtype: Optional[torch.dtype]
                ) -> Tuple[torch.Tensor, ...]:
    """(mean, var, A, A L_S) of q(f(x)) in `dtype` (default: the
    parameters', at least f32)."""
    l_k = kzz_chol(gp, dtype)                                  # (D, M, M)
    dt = l_k.dtype
    outputscale = F.softplus(gp.raw_outputscale.to(dt))
    kxz = rbf(outputscale, F.softplus(gp.raw_lengthscale.to(dt)), x.to(dt),
              gp.z.to(dt))                                     # (..., D, B, M)
    a = torch.linalg.solve_triangular(l_k, kxz.transpose(-1, -2),
                                      upper=False).transpose(-1, -2)
    mean = gp.mean_const.to(dt)[:, None] + torch.einsum(
        "...dbm,dm->...db", a, gp.var_mean.to(dt))
    a_ls = torch.einsum("...dbm,dmn->...dbn", a, torch.tril(gp.var_chol.to(dt)))
    var = (outputscale[:, None] - torch.sum(a * a, dim=-1)
           + torch.sum(a_ls * a_ls, dim=-1))
    return mean, torch.clamp(var, min=1e-10), a, a_ls


def posterior(gp: SVGP, x: torch.Tensor) -> GPPosterior:
    """q(f(x)) for x (..., D, B, 1), leading axes batched (the train step
    passes its T−1 steps as one): A = K_XZ L⁻ᵀ by a triangular solve
    against chol(K_ZZ + jitter), mean = μ + A m, var = k(x,x) − ‖A‖² +
    ‖A L_S‖². Differentiable in every parameter and in x."""
    return GPPosterior(*_predictive(gp, x, None)[:2])


def predictive_variance(gp: SVGP, lik: "GaussianLikelihood", x: torch.Tensor
                        ) -> torch.Tensor:
    """Variance of likelihood(gp(x)), diag(cov_f) + σ², (D, B): the
    GP trigger's signal, from the raw parameters."""
    return posterior(gp, x).var + f32up(lik.noise_variance())[:, None]


def posterior_full_cov(gp: SVGP, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean (D, B), full predictive covariance of f (D, B, B)) for x (D, B,
    1), computed and returned in at least f32 (bf16 inputs are promoted,
    f64 stays f64): kxx − A·Aᵀ + (A L_S)(A L_S)ᵀ cancels catastrophically
    near the inducing set, so a bf16 assembly loses the digits no later
    cast recovers and can leave the covariance indefinite."""
    ct = acc_dtype(x.dtype)
    xf = x.to(ct)
    mean, _, a, a_ls = _predictive(gp, xf, ct)
    cov = (rbf_cross(gp, xf, xf) - a @ a.transpose(-1, -2)
           + a_ls @ a_ls.transpose(-1, -2))
    return mean, cov


def rsample(gp: SVGP, lik: "GaussianLikelihood", x: torch.Tensor,
            full_cov: bool = False,
            generator: Optional[torch.Generator] = None,
            eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reparameterized sample of likelihood(gp(x)), (D, B), from the raw
    parameters. The standard-normal eps (D, B) is given, or drawn from
    `generator`. By default each batch row is drawn from its marginal;
    `full_cov` draws one sample correlated across the batch from the full
    posterior covariance plus σ² and jitter on the diagonal, through a
    Cholesky in at least f32, cast back to x's dtype."""
    noise = f32up(lik.noise_variance())[:, None]
    if full_cov:
        mean, cov = posterior_full_cov(gp, x)
        ct = mean.dtype
        eye = torch.eye(x.shape[1], dtype=ct, device=cov.device)
        chol = _chol(cov + (noise.to(ct)[..., None] + JITTER) * eye)
        e = _standard_normal(mean, generator, eps)
        return (mean + (chol @ e[..., None])[..., 0]).to(x.dtype)
    post = posterior(gp, x)
    e = _standard_normal(post.mean, generator, eps)
    return post.mean + torch.sqrt(post.var + noise.to(post.var.dtype)) * e


def _standard_normal(like: torch.Tensor, generator: Optional[torch.Generator],
                     eps: Optional[torch.Tensor]) -> torch.Tensor:
    """eps, or a draw from `generator`, shaped, typed and placed as `like`."""
    if eps is None:
        if generator is None:
            raise ValueError("rsample needs a generator or an eps tensor")
        eps = torch.randn(like.shape, generator=generator,
                          device=generator.device)
    return eps.to(like.dtype).to(like.device).expand_as(like)


def kl_divergence(gp: SVGP) -> torch.Tensor:
    """KL(q(v) ‖ N(0, I)) per task, (D,)."""
    m = f32up(gp.var_mean)
    l_s = torch.tril(f32up(gp.var_chol))
    diag = torch.diagonal(l_s, dim1=-2, dim2=-1)
    logdet_s = 2.0 * torch.sum(torch.log(torch.abs(diag) + 1e-20), dim=-1)
    return 0.5 * (torch.sum(l_s * l_s, dim=(-2, -1)) + torch.sum(m * m, dim=-1)
                  - m.shape[-1] - logdet_s)


def expected_log_prob(mean_f: torch.Tensor, var_f: torch.Tensor,
                      y: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """E_q(f)[log N(y | f, σ²)] per point."""
    return -0.5 * (LOG_2PI + torch.log(noise)
                   + ((y - mean_f) ** 2 + var_f) / noise)


def elbo(gp: SVGP, lik: "GaussianLikelihood", x: torch.Tensor,
         y: torch.Tensor, num_data: int,
         post: Optional[GPPosterior] = None) -> torch.Tensor:
    """Per-task ELBO (..., D): mean over the B points of the expected log
    likelihood minus KL / num_data (gpytorch's VariationalELBO). x (..., D,
    B, 1), y (..., D, B); `post`, if given, is posterior(gp, x)."""
    post = posterior(gp, x) if post is None else post
    noise = f32up(lik.noise_variance())[:, None]
    ll = expected_log_prob(post.mean, post.var, y.to(post.mean.dtype), noise)
    return ll.mean(dim=-1) - kl_divergence(gp) / num_data


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
    """Cache of the frozen GP, in at least f32 whatever the parameters'
    dtype."""
    l_k = kzz_chol(gp)
    eye = torch.eye(l_k.shape[-1], dtype=l_k.dtype,
                    device=l_k.device).expand_as(l_k)
    w = torch.linalg.solve_triangular(l_k, eye, upper=False).transpose(1, 2)
    v1 = torch.einsum("dmn,dn->dm", w, f32up(gp.var_mean))
    v2 = torch.einsum("dmn,dnk->dmk", w, torch.tril(f32up(gp.var_chol)))
    return GPCache(
        w=w, v1=v1, v2=v2, z=f32up(gp.z),
        mean_const=f32up(gp.mean_const),
        lengthscale=F.softplus(f32up(gp.raw_lengthscale)),
        outputscale=F.softplus(f32up(gp.raw_outputscale)),
        noise=f32up(lik.noise_variance()))


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
    caller (`fork_noise`, one column per (sample, row) pair). With a column
    per pair this is also the JAX package's `cached_rsample_pairs`."""
    mean, var = cached_mean_var(cache, x)
    return mean + torch.sqrt(var + cache.noise[:, None]) * eps


def cached_variance(cache: GPCache, x: torch.Tensor) -> torch.Tensor:
    """Variance of likelihood(gp(x)), (D, B): the GP-trigger's signal."""
    _, var = cached_mean_var(cache, x)
    return var + cache.noise[:, None]


def cached_rsample_fullcov(cache: GPCache, x: torch.Tensor,
                           eps: torch.Tensor) -> torch.Tensor:
    """Batch-correlated sample of likelihood(gp(x)): one draw from the full
    (D, B, B) posterior covariance plus noise, mean + chol(cov)·eps. x is
    (..., D, B, 1) and eps (..., D, B); leading dims are independent draws.

    The covariance is assembled in f32 from the (possibly bf16) inputs and
    the f32 cache: kxx − a·aᵀ + a_ls·a_lsᵀ cancels catastrophically near the
    inducing set, so a bf16 assembly can leave it indefinite and the
    Cholesky NaN. In f32 it is the exact posterior covariance of those
    inputs, PSD by construction. The sample comes back in x's dtype."""
    f32 = torch.float32
    xf = x.float()
    c = GPCache(*(t.to(f32) for t in cache))
    kxz = rbf(c.outputscale, c.lengthscale, xf, c.z)         # (..., D, B, M)
    a = torch.einsum("...dbm,dmn->...dbn", kxz, c.w)
    mean = c.mean_const[:, None] + torch.einsum("...dbm,dm->...db", kxz, c.v1)
    a_ls = torch.einsum("...dbm,dmn->...dbn", kxz, c.v2)
    kxx = rbf(c.outputscale, c.lengthscale, xf, xf)           # (..., D, B, B)
    cov = kxx - a @ a.transpose(-1, -2) + a_ls @ a_ls.transpose(-1, -2)
    b = x.shape[-2]
    eye = torch.eye(b, dtype=f32, device=x.device)
    cov = cov + (c.noise[:, None, None] + JITTER) * eye
    chol = _chol(cov)
    return (mean + (chol @ eps.to(f32)[..., None])[..., 0]).to(x.dtype)


# ---------------------------------------------------------------------------
# GP noise as a pure function of (seed, sample, step, row, latent index)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mix32(x):
    """A bijective 32-bit integer hash (Wellons' lowbias32 constants, both
    below 2³¹) on Python ints or int64 tensors holding 32-bit values: every
    product stays below 2⁶³, so the arithmetic is exact on any device."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _MASK32
    return x ^ (x >> 15)


def _scalar_key(*words):
    """The words hashed into one 32-bit key: a Python int, or an int64
    tensor where a word is one (an exported program's 0-dim seed input, a
    batch of steps: one key per element). The tensor arithmetic is the int
    arithmetic for every word in int64 range (both shift arithmetically),
    so the key is the same either way."""
    h = 0
    for w in words:
        w = w.to(torch.int64) if isinstance(w, torch.Tensor) else int(w)
        h = _mix32(h ^ ((w ^ (w >> 32)) & _MASK32))
    return h


def fork_noise(seed, sample_ids, step, row_ids, dim: int,
               device="cpu", dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """Standard-normal eps for every (sample, row) pair asked for:
    `sample_ids` and `row_ids` broadcast against each other, and the result
    has their broadcast shape + (dim,).

    eps[..., d] is a pure function of (seed, sample id, step, global row id,
    d): integer hashing into two 24-bit uniforms, then Box–Muller in f64. It
    does not depend on which other pairs are in the call or on the device
    (CPU and card agree to the last f32 ulp of the f64 log/cos), so a
    re-roll of any subset of pairs reproduces the draws of the full run.
    `seed` is an int or a 0-dim int64 tensor, with bit-equal eps for equal
    values: a traced program takes it as an input instead of baking it in.
    `step` is an int, or an int64 tensor that broadcasts with the ids (the
    result then has the shape of all three): many steps' draws in one
    call, each bit-equal to its own call's.
    One hash over a (pairs, 2·dim) int64 tensor plus the Box–Muller
    transform: about twenty elementwise kernels per call."""
    dev = torch.device(device)
    ids = torch.broadcast_tensors(
        torch.as_tensor(sample_ids, dtype=torch.int64, device=dev),
        torch.as_tensor(row_ids, dtype=torch.int64, device=dev))
    salt = torch.as_tensor(_scalar_key(0x5EED, seed, step), device=dev)
    pair = _mix32(salt ^ (ids[0] & _MASK32))
    pair = _mix32(pair ^ _mix32(ids[1] & _MASK32))
    lane = _mix32(torch.arange(2 * dim, dtype=torch.int64, device=dev)
                  + 0x9E3779B)
    bits = _mix32(pair[..., None] ^ lane) >> 8               # 24-bit
    u = bits.to(torch.float64).unflatten(-1, (dim, 2))
    u1 = (u[..., 0] + 1.0) * 2.0 ** -24                       # (0, 1]
    u2 = u[..., 1] * 2.0 ** -24                               # [0, 1)
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return eps.to(dtype)
