"""The port against `dvg_tpu` on trained weights (the port's counterpart
of tests/test_trained_model_parity.py), on the CPU in f32.

The weights: by default the port trains itself here, in f32 with its own
train step (`dvg_tpu_torch.train.make_train_step`, all three passes), at
`__graft_entry__._tiny_cfg`'s widths (g_dim 16, rnn 64, 8 inducing
points, B 8, n_past 2, n_future 2) on procedural Moving-MNIST, for
TRAIN_STEPS steps. The fixture checks that they are trained, not seeded:
the mean loss of the last 5 steps is under LOSS_FALL of the first step's,
the GP's variational Cholesky L_S has left the identity (max |L_S − I| over
1e-2), and the trigger's signal moves: at the protocol's thresholds
(trigger_sigma 2.01, margin 0) the variance norms of `gp_trigger`'s
warm-up vary by over 1e-4 relative in every checked row (at L_S = I they
are one constant). `DVG_TRAINED_PARAMS=PATH` names trained weights
instead, as `torch.save({"cfg": dataclasses.asdict(cfg), "state_dict":
model.state_dict()}, PATH)` keeps them (a soak's), and skips those checks:

    DVG_TRAINED_PARAMS=PATH python -m pytest tests/test_torch_trained_parity.py

Both packages get the same weights (`convert.params_to_jax`) and the first
test batch of the procedural digits:

  * `posterior` frames (2 rows, n_eval 30) against dvg_tpu's at atol
    5e-4, the SSIM tolerance below: a trained model's free run carries
    the two packages' f32 rounding further at every step (the error of
    each free step is printed);
  * `diverse_metrics` fed the eps dvg_tpu derives from its key (S 4, 2
    rows, forks at steps 15 and 30) against dvg_tpu's without its Pallas
    kernel, at tests/test_torch_rollout.py's tolerances (SSIM 5e-4, PSNR
    1e-2 dB, MSE rtol 1e-3), and the same best-of-N;
  * the protocol's statistics (S 10, STAT_ROWS rows, STAT_N_EVAL frames,
    the same eps): posterior SSIM within 5e-3, mean SSIM and best-of-10
    within 1e-2. Single scores part by up to the one-ulp movement of a
    long free run; their means do not;
  * `gp_trigger` (TRIGGER_ROWS rows, n_eval 30, the eps dvg_tpu derives
    from its key) at the protocol's threshold and forking every step: the
    same fork decisions and variance norms within TRIGGER_RTOL.

A model this small, trained this briefly, settles its free run within a
few steps (the JAX package's trained test found the same): the variance
norm after the warm-up is constant up to f32 rounding, so a fork at the
protocol's threshold is rounding, and the protocol case compares each row
up to the first fork of either package.
"""

import dataclasses
import os
import time

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
from dvg_tpu_torch.train import init_train_state, make_train_step
from test_torch_generate import jax_noise_trigger
from test_torch_rollout import jax_noise

PARAMS = os.environ.get("DVG_TRAINED_PARAMS", "")
ROWS, S, N_EVAL = 2, 4, 30     # n_eval 30: steps 15 and 30 fork
FRAME_ATOL = 5e-4
STAT_ROWS, STAT_S, STAT_N_EVAL = 4, 10, 30
TRIGGER_ROWS, TRIGGER_RTOL = 8, 1e-4
# the port's training here: __graft_entry__._tiny_cfg's geometry in f32
TRAIN = dict(dataset="smmnist", channels=1, image_width=64, batch_size=8,
             n_past=2, n_future=2, n_eval=4, g_dim=16, rnn_size=64,
             num_inducing_points=8, ft=True, data_root="", dtype="float32",
             seed=1)
TRAIN_STEPS, LOSS_FALL = 40, 0.5


def train_port() -> tuple:
    """TRAIN_STEPS steps of the port's train step from its seeded init →
    (training config, state_dict, the step losses)."""
    cfg = DVGConfig(**TRAIN, epoch_size=TRAIN_STEPS)
    state = init_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    loader = Loader(load_dataset(cfg, seq_len=cfg.n_past + cfg.n_future,
                                 split="train"), cfg.batch_size,
                    seed=cfg.seed, num_threads=1, device="cpu")
    losses = []
    try:
        for k in range(TRAIN_STEPS):
            _, m = step(state, loader.next_batch(k))
            losses.append(float(m["loss"]))
    finally:
        loader.stop()
    return cfg, state.model.state_dict(), losses


def first_test_batch(cfg: DVGConfig, n_eval: int) -> np.ndarray:
    """The first test batch of 50 procedural clips, (n_eval, 50, H, W, C)."""
    loader = Loader(load_dataset(cfg.replace(batch_size=50), seq_len=n_eval,
                                 split="test"), 50, shuffle=False,
                    seed=cfg.seed, num_threads=1, device="cpu")
    try:
        return np.asarray(loader.next_batch(0)).astype(np.float32)
    finally:
        loader.stop()


@pytest.fixture(scope="module")
def trained():
    if PARAMS:
        saved = torch.load(PARAMS, weights_only=True)
        train_cfg = DVGConfig(**saved["cfg"])
        state_dict, losses = saved["state_dict"], None
    else:
        t0 = time.perf_counter()
        train_cfg, state_dict, losses = train_port()
        print(f"the port trained {TRAIN_STEPS} f32 steps in "
              f"{time.perf_counter() - t0:.1f} s: loss {losses[0]:.1f} → "
              f"{np.mean(losses[-5:]):.1f} (mean of the last 5)")
    cfg = train_cfg.generation_override().replace(
        dtype="float32", nsample=S, batch_size=ROWS, n_eval=N_EVAL,
        n_future=N_EVAL - train_cfg.n_past, data_root="", use_pallas=False)
    port = DVGModel(cfg, device="cpu")
    port.load_state_dict(state_dict)
    fields = {f.name for f in dataclasses.fields(JaxConfig)}
    jcfg = JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                        if k in fields})
    params, stats = params_to_jax(state_dict, cfg)
    clips = first_test_batch(cfg, train_cfg.generation_override().n_eval)
    jmodel = JaxModel(jcfg)
    if losses is not None:
        # trained, not seeded: the loss fell, L_S left I, the signal moves
        assert np.mean(losses[-5:]) < LOSS_FALL * losses[0], losses
        l_s = torch.tril(port.gp.var_chol.detach())
        off = (l_s - torch.eye(l_s.shape[-1])).abs().max().item()
        print(f"L_S max|L_S - I| {off:.3e}")
        assert off > 1e-2
        _, diag = make_rollout_fns(port, cfg.replace(
            batch_size=TRIGGER_ROWS)).gp_trigger(
                clips[:N_EVAL, :TRIGGER_ROWS], device="cpu")
        warm = diag["warmup_values"]
        moved = (warm.std(0) / warm.mean(0)).min().item()
        print(f"gp_trigger at the protocol's thresholds: warm-up variance "
              f"norms move {moved:.1e} relative at least, "
              f"{int(diag['triggers'].sum())} forks of "
              f"{diag['triggers'].numel()}")
        assert moved > 1e-4
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
    n_eval = min(STAT_N_EVAL, clips.shape[0])
    cfg = cfg.replace(n_eval=n_eval, batch_size=STAT_ROWS, nsample=STAT_S,
                      n_future=n_eval - cfg.n_past)
    jcfg = jcfg.replace(n_eval=cfg.n_eval, batch_size=STAT_ROWS,
                        nsample=STAT_S, n_future=cfg.n_future)
    x = clips[:n_eval, :STAT_ROWS]
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


@pytest.mark.parametrize("margin", [0.0, 1e6], ids=["protocol", "every_step"])
def test_gp_trigger_matches_dvg_tpu(trained, margin):
    """The counterpart of tests/test_trained_model_parity.py's
    test_trained_gp_trigger_verbatim_parity: on the trained weights the
    port's gp_trigger (TRIGGER_ROWS rows, n_eval 30, the eps dvg_tpu
    derives from its key) gives dvg_tpu's variance norms within
    TRIGGER_RTOL and its fork decisions. At the protocol's threshold a
    settled free run's window holds values equal to f32 rounding (a fork
    there is rounding, in either package), so each row is compared up to
    the first step at which either package forks, as the JAX package's
    test compares up to the first fork; with every step forking, the whole
    run."""
    cfg, jcfg, port, jmodel, params, stats, clips = trained
    cfg = cfg.replace(batch_size=TRIGGER_ROWS, trigger_margin=margin)
    jcfg = jcfg.replace(batch_size=TRIGGER_ROWS, trigger_margin=margin)
    x = clips[:N_EVAL, :TRIGGER_ROWS]
    key = jax.random.PRNGKey(cfg.seed + 31)
    _, diag_j = j_make_rollout_fns(jmodel, jcfg).gp_trigger(
        params, stats, jmodel.gp_cache(params), jnp.asarray(x), key)
    _, diag = make_rollout_fns(port, cfg).gp_trigger(
        x, noise=jax_noise_trigger(key, N_EVAL, TRIGGER_ROWS, cfg.g_dim),
        device="cpu")
    trig, j_trig = diag["triggers"].numpy(), np.asarray(diag_j["triggers"])
    vals, j_vals = diag["values"].numpy(), np.asarray(diag_j["values"])
    np.testing.assert_allclose(diag["warmup_values"].numpy(),
                               diag_j["warmup_values"], rtol=TRIGGER_RTOL)
    if margin:
        np.testing.assert_array_equal(trig, j_trig)
        assert trig.all()
        np.testing.assert_allclose(vals, j_vals, rtol=TRIGGER_RTOL)
        rel = np.abs(vals / j_vals - 1).max()
    else:
        either = trig | j_trig
        first = np.where(either.any(0), either.argmax(0), len(either) - 1)
        for r, f in enumerate(first):
            np.testing.assert_array_equal(trig[:f, r], j_trig[:f, r])
            np.testing.assert_allclose(vals[:f + 1, r], j_vals[:f + 1, r],
                                       rtol=TRIGGER_RTOL)
        rel = max(np.abs(vals[:f + 1, r] / j_vals[:f + 1, r] - 1).max()
                  for r, f in enumerate(first))
    print(f"trained weights, f32 CPU, port vs dvg_tpu, trigger_margin "
          f"{margin:g}: forks {int(trig.sum())} / {int(j_trig.sum())} of "
          f"{trig.size}, variance norms max rel diff {rel:.2e}")
