"""Port parity for the rest of generation: posterior, diverse,
diverse_select, diverse_select_pairs, diverse_rollout_with_keys,
plot_samples, gp_trigger, `full_cov_sampling` and `last_frame_skip` of
`dvg_tpu_torch` against `dvg_tpu`'s `make_rollout_fns` on the CPU — f32,
the same unit-gain weights (test_torch_rollout.jax_state) and the GP noise
built in JAX exactly as `dvg_tpu` derives it, passed to the port as
`noise`. The geometry forks inside the free run (n_past 2, n_eval 17: the
%15 schedule forks at step 15, plot_samples at step 10) and gives
gp_trigger five steps after its 12-step warm-up.

Tolerances: frames atol 1e-4; gp_trigger masks equal, values rtol 1e-4;
metrics as in test_torch_rollout (SSIM atol 5e-4, PSNR 1e-2 dB, MSE rtol
1e-3). Plus the port's own seeded noise: a pure function of (seed, sample,
step, row), so re-rolls reproduce the scored futures."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.generate.rollout import make_rollout_fns as j_make_rollout_fns
from dvg_tpu.models.dvg import DVGModel as JaxModel
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import params_from_jax
from dvg_tpu_torch.generate.rollout import make_rollout_fns
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.models.gp import fork_noise
from dvg_tpu_torch.ops.ssim import ssim_psnr_images_plain
from test_torch_rollout import TINY, jax_noise, jax_state

FRAME_ATOL = 1e-4
S, B, T, N_FREE, D = 3, 2, 17, 15, TINY["g_dim"]
WARMUP = 12


def jax_noise_fullcov(key, s_n, n_free, b, d):
    """(n_free, S, B, D): the correlated draw's eps exactly as dvg_tpu
    derives it — per sample split(key, S), per step split(·, n_free), then
    normal(step_key, (D, B)) — in the port's (row, latent) order."""
    step_keys = jnp.swapaxes(jax.vmap(lambda k: jax.random.split(k, n_free))(
        jax.random.split(key, s_n)), 0, 1)
    eps = jax.vmap(jax.vmap(
        lambda k: jax.random.normal(k, (d, b), jnp.float32)))(step_keys)
    return np.array(eps).transpose(0, 1, 3, 2)


def jax_noise_trigger(key, total, b, d):
    """(total − 12, B, D): gp_trigger's eps, normal(split(key, total)[i],
    (D, B)) for the steps after the warm-up."""
    keys = jax.random.split(key, total)[WARMUP:]
    eps = jax.vmap(lambda k: jax.random.normal(k, (d, b), jnp.float32))(keys)
    return np.array(eps).transpose(0, 2, 1)


class Pair:
    """One model in both packages, and a clip."""

    def __init__(self, **kw):
        self.jcfg = JaxConfig(**dict(TINY, **kw))
        self.jmodel = JaxModel(self.jcfg)
        params, self.stats = jax_state(self.jmodel, seed=0)
        # a non-identity variational Cholesky: with L_S = I the GP variance
        # is the constant outputscale and the trigger's signal never moves
        rng = np.random.RandomState(3)
        m = TINY["num_inducing_points"]
        var_chol = (np.eye(m) * rng.uniform(0.2, 0.6, (D, 1, m))
                    + np.tril(rng.normal(0, 0.1, (D, m, m)), -1))
        self.params = dict(params, gp=dict(
            params["gp"], var_chol=jnp.asarray(var_chol, jnp.float32)))
        self.cache = self.jmodel.gp_cache(self.params)
        self.cfg = DVGConfig(**dict(TINY, **kw))
        self.port = DVGModel(self.cfg, device="cpu")
        self.port.load_state_dict(params_from_jax(self.params, self.stats,
                                                  self.cfg))
        self.x = np.random.RandomState(1).rand(T, B, 64, 64, 3).astype(
            np.float32)

    def jfns(self, **kw):
        return j_make_rollout_fns(self.jmodel, self.jcfg.replace(**kw))

    def fns(self, **kw):
        return make_rollout_fns(self.port, self.cfg.replace(**kw))

    def jcall(self, fn, *args):
        return fn(self.params, self.stats, self.cache, jnp.asarray(self.x),
                  *args)


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def diverse(pair):
    """The JAX package's diverse futures and the port's, same noise."""
    key = jax.random.PRNGKey(2)
    ref = np.asarray(pair.jcall(pair.jfns().diverse, key))
    noise = jax_noise(key, S, N_FREE, B, D)
    out = pair.fns().diverse(pair.x, noise=noise, device="cpu").numpy()
    return key, noise, ref, out


def _close(out, ref, atol=FRAME_ATOL):
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, np.asarray(ref), atol=atol, rtol=0)


def test_posterior_matches_jax(pair):
    ref = pair.jcall(pair.jfns().posterior)
    _close(pair.fns().posterior(pair.x, device="cpu"), ref)


def test_diverse_matches_jax(diverse):
    key, noise, ref, out = diverse
    assert out.shape == (S, T, B, 64, 64, 3)
    _close(out, ref)
    # the fork at step 15 moves the samples apart by many times the
    # tolerance (a miswired fork cannot pass); before it they agree
    spread = np.ptp(out[:, 15], axis=0).max(axis=(1, 2, 3))
    assert spread.min() > 100 * FRAME_ATOL
    assert np.ptp(out[:, :15], axis=0).max() == 0


def test_diverse_select_matches_jax(pair, diverse):
    key, noise, ref, _ = diverse
    ids, row = [2, 0], 1
    got = pair.fns().diverse_select(pair.x[:, row:row + 1], ids, [row],
                                    noise=noise[:, ids][:, :, [row]],
                                    device="cpu")
    j_sel = pair.jfns().diverse_select(
        pair.params, pair.stats, pair.cache, jnp.asarray(pair.x[:, row:row + 1]),
        key, jnp.asarray(ids), jnp.asarray([row]))
    _close(got, j_sel)
    _close(got[:, :, 0], ref[ids, :, row])


def test_diverse_select_pairs_matches_jax(pair, diverse):
    key, noise, ref, _ = diverse
    pairs = [(2, 1), (0, 0), (1, 0), (2, 0)]              # (sample, row)
    ids = np.asarray([p[0] for p in pairs])
    rows = np.asarray([p[1] for p in pairs])
    base_keys = jnp.take(jax.random.split(key, S), jnp.asarray(ids), axis=0)
    j_out = pair.jfns().diverse_select_pairs(
        pair.params, pair.stats, pair.cache, jnp.asarray(pair.x[:, rows]),
        base_keys, jnp.asarray(rows))
    got = pair.fns().diverse_select_pairs(
        pair.x[:, rows], ids, rows, noise=noise[:, ids, rows], device="cpu")
    assert got.shape == (T, len(pairs), 64, 64, 3)
    _close(got, j_out)
    for k, (s, r) in enumerate(pairs):
        _close(got[:, k], ref[s, :, r])


def test_plot_samples_matches_jax(pair):
    key = jax.random.PRNGKey(5)
    ref = np.asarray(pair.jcall(pair.jfns().plot_samples, key))
    got = pair.fns().plot_samples(pair.x, noise=jax_noise(key, 5, N_FREE, B, D),
                                  device="cpu")
    assert got.shape == (5, T, B, 64, 64, 3)
    _close(got, ref)
    assert np.ptp(got[:, 10].numpy(), axis=0).max() > 100 * FRAME_ATOL


def test_full_cov_matches_jax(pair):
    """--full_cov: the batch-correlated draw, its in-loop metrics, the
    full-batch keyed re-roll, and the two re-roll refusals."""
    key = jax.random.PRNGKey(31)
    jfns, fns = pair.jfns(full_cov_sampling=True), pair.fns(
        full_cov_sampling=True)
    noise = jax_noise_fullcov(key, S, N_FREE, B, D)
    ref = np.asarray(pair.jcall(jfns.diverse, key))
    got = fns.diverse(pair.x, noise=noise, device="cpu")
    _close(got, ref)
    met = fns.diverse_metrics(pair.x, noise=noise, device="cpu")
    j_met = pair.jcall(jfns.diverse_metrics, key)
    np.testing.assert_allclose(met["ssim"].numpy(), j_met["ssim"], atol=5e-4)
    np.testing.assert_allclose(met["psnr"].numpy(), j_met["psnr"], atol=1e-2)
    np.testing.assert_allclose(met["mse"].numpy(), j_met["mse"], rtol=1e-3)
    re = fns.diverse_rollout_with_keys(pair.x, [1], noise=noise[:, 1:2],
                                       device="cpu")
    _close(re[0], ref[1])
    with pytest.raises(ValueError, match="whole batch"):
        fns.diverse_select(pair.x[:, :1], [1], [0], device="cpu")
    with pytest.raises(ValueError, match="MARGINAL"):
        fns.diverse_select_pairs(pair.x[:, :1], [1], [0], device="cpu")


def test_last_frame_skip_matches_jax(pair):
    key = jax.random.PRNGKey(13)
    jfns, fns = pair.jfns(last_frame_skip=True), pair.fns(last_frame_skip=True)
    post = fns.posterior(pair.x, device="cpu")
    _close(post, pair.jcall(jfns.posterior))
    # the refreshed skips change the very first generated frame
    frozen = pair.fns().posterior(pair.x, device="cpu")
    assert (post[2] - frozen[2]).abs().max() > 100 * FRAME_ATOL
    met = fns.diverse_metrics(pair.x, noise=jax_noise(key, S, N_FREE, B, D),
                              device="cpu")
    j_met = pair.jcall(jfns.diverse_metrics, key)
    np.testing.assert_allclose(met["ssim"].numpy(), j_met["ssim"], atol=5e-4)
    np.testing.assert_allclose(met["psnr"].numpy(), j_met["psnr"], atol=1e-2)
    np.testing.assert_allclose(met["mse"].numpy(), j_met["mse"], rtol=1e-3)


# trigger_margin 0 is the reference's threshold; 0.01 fires on some of the
# steps of this clip (the nearest value sits 1.3e-3 from its threshold),
# 1e6 on every step
@pytest.mark.parametrize("margin,fires", [(0.0, None), (0.01, "some"),
                                         (1e6, "all")])
@pytest.mark.parametrize("full_cov", [False, True])
def test_gp_trigger_matches_jax(pair, margin, fires, full_cov):
    key = jax.random.PRNGKey(32)
    kw = dict(trigger_margin=margin, full_cov_sampling=full_cov)
    frames_j, diag_j = pair.jcall(pair.jfns(**kw).gp_trigger, key)
    frames, diag = pair.fns(**kw).gp_trigger(
        pair.x, noise=jax_noise_trigger(key, T, B, D), device="cpu")
    trig = diag["triggers"].numpy()
    assert trig.shape == (T - WARMUP, B)
    np.testing.assert_array_equal(trig, np.asarray(diag_j["triggers"]))
    np.testing.assert_allclose(diag["values"].numpy(), diag_j["values"],
                               rtol=1e-4)
    np.testing.assert_allclose(diag["warmup_values"].numpy(),
                               diag_j["warmup_values"], rtol=1e-4)
    _close(frames, frames_j)
    if fires == "all":
        assert trig.all()
    elif fires == "some":
        assert trig.any() and not trig.all()


def test_gp_trigger_short_horizon_raises(pair):
    fns = make_rollout_fns(pair.port, pair.cfg.replace(n_eval=10))
    with pytest.raises(ValueError, match="warmup"):
        fns.gp_trigger(pair.x[:10], device="cpu")


# ---------------------------------------------------------------------------
# the port's own seeded noise
# ---------------------------------------------------------------------------

def test_fork_noise_is_a_pure_function_of_its_ids():
    full = fork_noise(7, torch.arange(4)[:, None], 3, torch.arange(6)[None],
                      D)
    assert full.shape == (4, 6, D) and full.dtype == torch.float32
    sub = fork_noise(7, torch.tensor([3, 1]), 3, torch.tensor([5, 2]), D)
    assert torch.equal(sub, torch.stack([full[3, 5], full[1, 2]]))
    for other in (fork_noise(8, torch.arange(4)[:, None], 3,
                             torch.arange(6)[None], D),
                  fork_noise(7, torch.arange(4)[:, None], 4,
                             torch.arange(6)[None], D)):
        assert (other - full).abs().min() > 0
    big = fork_noise(0, torch.arange(100)[:, None], 0,
                     torch.arange(50)[None], 90).double()
    assert abs(big.mean()) < 0.01 and abs(big.std() - 1) < 0.01


def test_seeded_reroll_reproduces_scored_futures(pair):
    """diverse_metrics(seed) scores futures that diverse_select_pairs with
    the same seed re-rolls exactly: the K2 plain scores of the re-rolled
    frames equal the in-loop K1 scores."""
    fns = pair.fns()
    met = fns.diverse_metrics(pair.x, seed=9, device="cpu")
    pairs = [(2, 1), (0, 0), (1, 1)]
    ids = [p[0] for p in pairs]
    rows = [p[1] for p in pairs]
    frames = fns.diverse_select_pairs(pair.x[:, rows], ids, rows, seed=9,
                                      device="cpu")
    gt = torch.from_numpy(pair.x[2:, rows]).reshape(-1, 64, 64, 3)
    s, q, m = (v.reshape(N_FREE, len(pairs)) for v in ssim_psnr_images_plain(
        gt, frames[2:].reshape(-1, 64, 64, 3)))
    for k, (smp, r) in enumerate(pairs):
        np.testing.assert_allclose(s[:, k], met["ssim"][smp, :, r], atol=1e-5)
        np.testing.assert_allclose(q[:, k], met["psnr"][smp, :, r], atol=1e-3)
        np.testing.assert_allclose(m[:, k], met["mse"][smp, :, r], rtol=1e-4)
    # the fork really separates the samples this re-roll tells apart
    assert np.ptp(met["mse"][:, 13].numpy(), axis=0).min() > 0
