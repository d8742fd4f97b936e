"""The port against `dvg_tpu` on trained weights (the port's counterpart
of tests/test_trained_model_parity.py), on the CPU in f32: the weights a
training run of the port wrote, as `torch.save({"cfg":
dataclasses.asdict(cfg), "state_dict": model.state_dict()}, PATH)` keeps
them, loaded into both packages (`convert.params_to_jax`), on the soak's
first test batch:

  * `posterior` frames (2 rows, n_eval 30) against dvg_tpu's at atol
    5e-4, the SSIM tolerance below: a trained model's free run carries
    the two packages' f32 rounding further at every step (the error of
    each free step is printed);
  * `diverse_metrics` fed the eps dvg_tpu derives from its key (S 4, 2
    rows, forks at steps 15 and 30) against dvg_tpu's without its Pallas
    kernel, at tests/test_torch_rollout.py's tolerances (SSIM 5e-4, PSNR
    1e-2 dB, MSE rtol 1e-3), and the same best-of-N;
  * the protocol's statistics at full length (n_eval 105, S 10, 10 rows,
    the same eps): posterior SSIM within 5e-3, mean SSIM and best-of-10
    within 1e-2. Single scores part by up to the one-ulp movement over 100
    free steps; their means over 1,000 scores do not.

    DVG_TRAINED_PARAMS=PATH python -m pytest tests/test_torch_trained_parity.py

Skipped where no such file is named: trained weights are not committed
(44 MB), so only a run that has them (a soak's `trained_params.pt`, or
`torch.save({"cfg": ..., "state_dict": ...})` of a trained model) checks
this.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.generate.rollout import make_rollout_fns as j_make_rollout_fns
from dvg_tpu.models.dvg import DVGModel as JaxModel
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import params_to_jax
from dvg_tpu_torch.data import Loader, load_dataset
from dvg_tpu_torch.generate.rollout import best_of_n, make_rollout_fns
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.ops.ssim import ssim_psnr_images_plain
from test_torch_rollout import jax_noise

PARAMS = os.environ.get("DVG_TRAINED_PARAMS", "")
pytestmark = pytest.mark.skipif(
    not os.path.isfile(PARAMS),
    reason="DVG_TRAINED_PARAMS names no file of trained weights")
ROWS, S, N_EVAL = 2, 4, 30     # n_eval 30: steps 15 and 30 fork
FRAME_ATOL = 5e-4
STAT_ROWS, STAT_S = 10, 10


@pytest.fixture(scope="module")
def trained():
    saved = torch.load(PARAMS, weights_only=True)
    cfg = DVGConfig(**saved["cfg"]).generation_override().replace(
        dtype="float32", nsample=S, batch_size=ROWS, n_eval=N_EVAL,
        n_future=N_EVAL - saved["cfg"]["n_past"], data_root="",
        use_pallas=False)
    port = DVGModel(cfg, device="cpu")
    port.load_state_dict(saved["state_dict"])
    fields = {f.name for f in dataclasses.fields(JaxConfig)}
    jcfg = JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                        if k in fields})
    params, stats = params_to_jax(saved["state_dict"], cfg)
    protocol = DVGConfig(**saved["cfg"]).generation_override()
    loader = Loader(load_dataset(cfg.replace(batch_size=50),
                                 seq_len=protocol.n_eval, split="test"), 50,
                    shuffle=False, seed=cfg.seed, num_threads=1,
                    device="cpu")
    try:
        clips = np.asarray(loader.next_batch(0)).astype(np.float32)
    finally:
        loader.stop()
    jmodel = JaxModel(jcfg)
    return cfg, jcfg, port, jmodel, params, stats, clips


def test_posterior_matches_dvg_tpu(trained):
    cfg, jcfg, port, jmodel, params, stats, clips = trained
    x = clips[:N_EVAL, :ROWS]
    ref = j_make_rollout_fns(jmodel, jcfg).posterior(
        params, stats, jmodel.gp_cache(params), jnp.asarray(x))
    got = make_rollout_fns(port, cfg).posterior(x, device="cpu")
    assert got.shape == (N_EVAL, ROWS) + x.shape[2:]
    steps = np.abs(got.numpy() - np.asarray(ref)).max(axis=(1, 2, 3, 4))
    print(f"trained weights, f32 CPU, port vs dvg_tpu: posterior "
          f"max|dframe| by free step " + " ".join(
              f"{v:.1e}" for v in steps[cfg.n_past:]))
    assert steps.max() <= FRAME_ATOL


def test_diverse_metrics_matches_dvg_tpu(trained):
    cfg, jcfg, port, jmodel, params, stats, clips = trained
    x = clips[:N_EVAL, :ROWS]
    key = jax.random.PRNGKey(cfg.seed)
    n_free = N_EVAL - cfg.n_past
    noise = jax_noise(key, S, n_free, ROWS, cfg.g_dim)
    ref = j_make_rollout_fns(jmodel, jcfg).diverse_metrics(
        params, stats, jmodel.gp_cache(params), jnp.asarray(x), key)
    out = make_rollout_fns(port, cfg).diverse_metrics(x, noise=noise,
                                                      device="cpu")
    ref = {k: np.array(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    for k in ("ssim", "psnr", "mse"):
        assert out[k].shape == (S, n_free, ROWS)
        assert np.all(np.isfinite(out[k]))
    np.testing.assert_allclose(out["ssim"], ref["ssim"], atol=5e-4)
    np.testing.assert_allclose(out["psnr"], ref["psnr"], atol=1e-2)
    np.testing.assert_allclose(out["mse"], ref["mse"], rtol=1e-3)
    idx, _ = best_of_n(torch.from_numpy(np.transpose(out["ssim"], (2, 0, 1))))
    j_idx, _ = best_of_n(torch.from_numpy(np.transpose(ref["ssim"],
                                                       (2, 0, 1))))
    assert torch.equal(idx, j_idx)
    print(f"trained weights, f32 CPU, port vs dvg_tpu: max|dssim| "
          f"{np.abs(out['ssim'] - ref['ssim']).max():.3e} max|dpsnr| "
          f"{np.abs(out['psnr'] - ref['psnr']).max():.3e} dB max rel dmse "
          f"{(np.abs(out['mse'] - ref['mse']) / ref['mse']).max():.3e}")


def _ssim_of(frames, x, n_past):
    gt = torch.from_numpy(x[n_past:]).flatten(0, 1)
    pred = torch.as_tensor(np.array(frames[n_past:])).flatten(0, 1).float()
    return ssim_psnr_images_plain(gt, pred)[0].mean().item()


def test_protocol_statistics_match_dvg_tpu(trained):
    cfg, jcfg, port, jmodel, params, stats, clips = trained
    cfg = cfg.replace(n_eval=clips.shape[0], batch_size=STAT_ROWS,
                      nsample=STAT_S,
                      n_future=clips.shape[0] - cfg.n_past)
    jcfg = jcfg.replace(n_eval=cfg.n_eval, batch_size=STAT_ROWS,
                        nsample=STAT_S, n_future=cfg.n_future)
    x = clips[:, :STAT_ROWS]
    key = jax.random.PRNGKey(cfg.seed * 1000)
    noise = jax_noise(key, STAT_S, cfg.n_eval - cfg.n_past, STAT_ROWS,
                      cfg.g_dim)
    fns, jmodel = make_rollout_fns(port, cfg), JaxModel(jcfg)
    jfns, cache = j_make_rollout_fns(jmodel, jcfg), jmodel.gp_cache(params)
    post = [_ssim_of(fns.posterior(x, device="cpu"), x, cfg.n_past),
            _ssim_of(jfns.posterior(params, stats, cache, jnp.asarray(x)),
                     x, cfg.n_past)]
    scores = [fns.diverse_metrics(x, noise=noise, device="cpu")["ssim"],
              torch.from_numpy(np.array(jfns.diverse_metrics(
                  params, stats, cache, jnp.asarray(x), key)["ssim"]))]
    means = [s.mean().item() for s in scores]
    bests = [best_of_n(s.permute(2, 0, 1))[1].mean().item() for s in scores]
    print(f"trained weights, f32 CPU, n_eval {cfg.n_eval}, {STAT_ROWS} rows, "
          f"S {STAT_S}, port / dvg_tpu: posterior SSIM {post[0]:.4f} / "
          f"{post[1]:.4f}, mean SSIM {means[0]:.4f} / {means[1]:.4f}, "
          f"best-of-{STAT_S} {bests[0]:.4f} / {bests[1]:.4f}")
    assert abs(post[0] - post[1]) <= 5e-3
    assert abs(means[0] - means[1]) <= 1e-2
    assert abs(bests[0] - bests[1]) <= 1e-2
