"""Port parity: the LSTM predictor, the SVGP inference cache and the GP
library API (`rbf_cross`, `kernel_diag`, `posterior`,
`predictive_variance`, `posterior_full_cov`, `rsample` and DVGModel's
`gp_*` layout wrappers) of `dvg_tpu_torch` against `dvg_tpu` on the CPU,
f32, same weights (carried across by `params_from_jax`) and the same numpy
/ JAX-derived noise. Tolerances: atol 1e-5; W of the cache also rtol 1e-4
(the triangular inverse amplifies the Cholesky's rounding by K_ZZ's
condition number); the full-covariance sample 1e-4 (a (B, B) Cholesky of
a cancelling sum)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.models import gp as jgp
from dvg_tpu.models.dvg import DVGModel as JaxModel
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import params_from_jax
from dvg_tpu_torch.models import gp as tgp
from dvg_tpu_torch.models.dvg import DVGModel

ATOL = 1e-5
TINY = dict(channels=3, image_width=64, batch_size=4, n_past=2, n_eval=17,
            g_dim=16, rnn_size=64, num_inducing_points=8, nsample=3)


def _np(t):
    return t.detach().cpu().numpy()


def perturbed_gp(params, seed):
    """A trained-looking GP: spread inducing points, non-zero variational
    mean, a non-identity variational Cholesky, non-default kernel scales
    and noise. The spread keeps K_ZZ well conditioned: at the init's
    clustered U[0, 1] points, f32 Cholesky rounding alone moves W far past
    the tolerance from an f64 truth in BOTH packages, which would test
    conditioning, not the port."""
    rng = np.random.RandomState(seed)
    gp = dict(params["gp"])
    d, m = gp["var_mean"].shape
    gp["z"] = jnp.asarray(np.linspace(-1, 1, m)[None, :, None]
                          + rng.uniform(-0.03, 0.03, (d, m, 1)), jnp.float32)
    gp["var_mean"] = jnp.asarray(rng.normal(0, 0.5, (d, m)), jnp.float32)
    gp["var_chol"] = jnp.asarray(
        np.eye(m) * rng.uniform(0.5, 1.0, (d, 1, m))
        + np.tril(rng.normal(0, 0.1, (d, m, m)), -1), jnp.float32)
    gp["mean_const"] = jnp.asarray(rng.normal(0, 0.1, d), jnp.float32)
    gp["raw_outputscale"] = jnp.asarray(rng.normal(0, 0.3, d), jnp.float32)
    gp["raw_lengthscale"] = jnp.asarray(rng.normal(-1.2, 0.1, d), jnp.float32)
    lik = {"raw_noise": jnp.asarray(rng.normal(-2.0, 0.3, d), jnp.float32)}
    return dict(params, gp=gp, likelihood=lik)


@pytest.fixture(scope="module")
def models():
    cfg = DVGConfig(**TINY)
    jmodel = JaxModel(JaxConfig(**TINY))
    params, stats = jmodel.init(jax.random.PRNGKey(0))
    params = perturbed_gp(params, seed=1)
    port = DVGModel(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, stats, cfg))
    return jmodel, params, stats, port


def test_lstm_predictor_steps(models):
    """Several steps of output and (h, c) over both layers."""
    jmodel, params, stats, port = models
    rng = np.random.RandomState(2)
    b, g = 4, TINY["g_dim"]
    j_hidden = jmodel.lstm_hidden_init(b)
    t_hidden = port.lstm_hidden_init(b)
    assert t_hidden[0].shape == (2, b, TINY["rnn_size"])
    for _ in range(4):
        x = rng.uniform(-1, 1, (b, g)).astype(np.float32)
        j_out, j_hidden = jmodel.predict_latent(params, j_hidden,
                                                jnp.asarray(x))
        t_out, t_hidden = port.predict_latent(t_hidden, torch.from_numpy(x))
        np.testing.assert_allclose(_np(t_out), np.asarray(j_out), atol=ATOL)
        for t_a, j_a in zip(t_hidden, j_hidden):
            np.testing.assert_allclose(_np(t_a), np.asarray(j_a), atol=ATOL)


def test_build_cache(models):
    jmodel, params, stats, port = models
    ref = jmodel.gp_cache(params)
    cache = port.gp_cache()
    np.testing.assert_allclose(_np(cache.w), np.asarray(ref.w), rtol=1e-4,
                               atol=ATOL)
    for name in ("v1", "v2", "z", "mean_const", "lengthscale", "outputscale",
                 "noise"):
        np.testing.assert_allclose(_np(getattr(cache, name)),
                                   np.asarray(getattr(ref, name)), atol=ATOL,
                                   err_msg=name)
    assert all(t.dtype == torch.float32 for t in cache)


def _latents(seed, b=4):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, TINY["g_dim"])).astype(np.float32)


def test_cached_mean_var(models):
    jmodel, params, stats, port = models
    h = _latents(3)
    m_ref, v_ref = jgp.cached_mean_var(jmodel.gp_cache(params),
                                       jmodel.to_gp_layout(jnp.asarray(h)))
    m, v = tgp.cached_mean_var(port.gp_cache(),
                               port.to_gp_layout(torch.from_numpy(h)))
    np.testing.assert_allclose(_np(m), np.asarray(m_ref), atol=ATOL)
    np.testing.assert_allclose(_np(v), np.asarray(v_ref), atol=ATOL)


def test_cached_rsample_with_jax_noise(models):
    """The port takes eps as an argument; given the eps the JAX package
    derives per row (normal(fold_in(key, row), (D,))), it draws the same
    sample."""
    jmodel, params, stats, port = models
    h = _latents(4)
    key = jax.random.PRNGKey(5)
    rows = jnp.arange(4) + 7
    ref = jgp.cached_rsample(jmodel.gp_cache(params),
                             jmodel.to_gp_layout(jnp.asarray(h)), key,
                             row_ids=rows)
    eps = jax.vmap(lambda r: jax.random.normal(
        jax.random.fold_in(key, r), (TINY["g_dim"],), jnp.float32))(rows)
    y = tgp.cached_rsample(port.gp_cache(),
                           port.to_gp_layout(torch.from_numpy(h)),
                           torch.from_numpy(np.asarray(eps).T.copy()))
    np.testing.assert_allclose(_np(y), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(_np(port.from_gp_layout(y)),
                               np.asarray(jmodel.from_gp_layout(ref)),
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the GP library API on the raw parameters (dvg_tpu/models/gp.py:94-202,
# dvg_tpu/models/dvg.py:102-126)
# ---------------------------------------------------------------------------

FULL_COV_ATOL = 1e-4


def _gp_x(seed, b=5):
    """(D, B, 1) latents in task layout, spread over the inducing points."""
    return np.random.RandomState(seed).uniform(
        -1, 1, (TINY["g_dim"], b, 1)).astype(np.float32)


def _jax_eps(seed, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                      jnp.float32))


def test_rbf_cross_and_kernel_diag(models):
    jmodel, params, stats, port = models
    x1, x2 = _gp_x(10, 5), _gp_x(11, 7)
    ref = jgp.rbf_cross(params["gp"], jnp.asarray(x1), jnp.asarray(x2))
    got = tgp.rbf_cross(port.gp, torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.shape == (TINY["g_dim"], 5, 7)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(_np(tgp.kernel_diag(port.gp, 5)),
                               np.asarray(jgp.kernel_diag(params["gp"], 5)),
                               atol=ATOL)


@pytest.mark.parametrize("name", ["posterior", "predictive_variance",
                                  "posterior_full_cov"])
def test_gp_deterministic(models, name):
    """posterior's mean and variance, the variance with the noise, and the
    full covariance with its mean, from the raw parameters."""
    jmodel, params, stats, port = models
    x = _gp_x(12)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if name == "posterior":
        post = jgp.posterior(params["gp"], jx)
        ref, got = (post.mean, post.var), tgp.posterior(port.gp, tx)
    elif name == "predictive_variance":
        ref = (jgp.predictive_variance(params["gp"], params["likelihood"],
                                       jx),)
        got = (tgp.predictive_variance(port.gp, port.likelihood, tx),)
    else:
        ref = jgp.posterior_full_cov(params["gp"], jx)
        got = tgp.posterior_full_cov(port.gp, tx)
        assert got[1].shape == (TINY["g_dim"], 5, 5)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("full_cov", [False, True])
def test_rsample_with_jax_eps(models, full_cov):
    """Given the eps dvg_tpu's rsample draws from its key (normal(key,
    (D, B))), the port's rsample draws the same sample."""
    jmodel, params, stats, port = models
    x = _gp_x(13)
    ref = jgp.rsample(params["gp"], params["likelihood"], jnp.asarray(x),
                      jax.random.PRNGKey(14), full_cov=full_cov)
    eps = _jax_eps(14, (TINY["g_dim"], 5))
    got = tgp.rsample(port.gp, port.likelihood, torch.from_numpy(x),
                      full_cov=full_cov, eps=torch.from_numpy(eps))
    np.testing.assert_allclose(_np(got), np.asarray(ref),
                               atol=FULL_COV_ATOL if full_cov else ATOL)


def test_rsample_generator(models):
    """A generator's draw is the eps form fed the same draw; without either
    rsample refuses."""
    jmodel, params, stats, port = models
    x = torch.from_numpy(_gp_x(15))
    for full_cov in (False, True):
        got = tgp.rsample(port.gp, port.likelihood, x, full_cov=full_cov,
                          generator=torch.Generator().manual_seed(3))
        eps = torch.randn((TINY["g_dim"], 5),
                          generator=torch.Generator().manual_seed(3))
        want = tgp.rsample(port.gp, port.likelihood, x, full_cov=full_cov,
                           eps=eps)
        assert got.shape == (TINY["g_dim"], 5) and torch.equal(got, want)
    with pytest.raises(ValueError, match="generator or an eps"):
        tgp.rsample(port.gp, port.likelihood, x)


def test_posterior_full_cov_promotes_bf16(models):
    """bf16 latents: the covariance is assembled and returned in f32 (a
    bf16 assembly of the cancelling sum can turn it indefinite), and the
    full-cov sample comes back in bf16, finite."""
    jmodel, params, stats, port = models
    x = torch.from_numpy(_gp_x(16)).to(torch.bfloat16)
    mean, cov = tgp.posterior_full_cov(port.gp, x)
    assert mean.dtype == cov.dtype == torch.float32
    want = tgp.posterior_full_cov(port.gp, x.float())
    for g, w in zip((mean, cov), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    y = tgp.rsample(port.gp, port.likelihood, x, full_cov=True,
                    generator=torch.Generator().manual_seed(4))
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("name", ["gp_posterior", "gp_elbo", "gp_mean",
                                  "gp_rsample", "gp_rsample_full_cov",
                                  "gp_variance"])
def test_dvg_gp_wrappers(models, name):
    """DVGModel's (B, g_dim) layout wrappers against dvg_tpu's DVGModel;
    the samples fed dvg_tpu's eps, transposed to (B, g_dim)."""
    jmodel, params, stats, port = models
    h, h_target = _latents(17, b=5), _latents(18, b=5)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    tol = FULL_COV_ATOL if name.endswith("full_cov") else ATOL
    if name == "gp_posterior":
        post = jmodel.gp_posterior(params, jh)
        ref, got = (post.mean, post.var), port.gp_posterior(th)
    elif name == "gp_elbo":
        ref = (jmodel.gp_elbo(params, jh, jnp.asarray(h_target), 7),)
        got = (port.gp_elbo(th, torch.from_numpy(h_target), 7),)
    elif name.startswith("gp_rsample"):
        full_cov = name.endswith("full_cov")
        ref = (jmodel.gp_rsample(params, jh, jax.random.PRNGKey(19),
                                 full_cov=full_cov),)
        eps = _jax_eps(19, (TINY["g_dim"], 5)).T.copy()
        got = (port.gp_rsample(th, full_cov=full_cov,
                               eps=torch.from_numpy(eps)),)
    else:
        ref, got = (getattr(jmodel, name)(params, jh),), (
            getattr(port, name)(th),)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(np.shape(r))
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=tol)
