"""Port parity: the LSTM predictor and the SVGP inference cache of
`dvg_tpu_torch` against `dvg_tpu` on the CPU, f32, same weights (carried
across by `params_from_jax`) and the same numpy / JAX-derived noise.
Tolerances: atol 1e-5; W of the cache also rtol 1e-4 (the triangular
inverse amplifies the Cholesky's rounding by K_ZZ's condition number)."""

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
