"""The port's train step (`dvg_tpu_torch.train`) against `dvg_tpu`'s on the
CPU, at the tiny config of tests/test_train.py (T 3, B 2, g_dim 8, rnn 16,
4 inducing points), from the same weights and clip made from a seed:

  * train-mode BN and its statistics against `layers.batchnorm_apply`;
  * the closed-form EMA fold against sequential running-stat updates, and
    its weights against `dvg_tpu`'s;
  * the grouped decoder's frames and per-call statistics against
    `decoder_apply_grouped`;
  * the GP's posterior, KL and ELBO, values and gradients, in f64;
  * the joint loss and its gradients in f64;
  * one whole step in f64: every parameter, BN statistic and Adam moment
    against `make_train_step_fn`;
  * three f64 steps at epoch_size 1 across both GP learning-rate
    milestones: the parameters and the GP rate after every step;
  * a bf16 step's losses within the measured drift band, and its
    gradient of the decoder's output bias against the f32 step's;
  * TrainState checkpoints across the two packages, an exact resume, and
    --remat giving the same step.

The JAX step is jitted once per module (its compile dominates this file).

Noise tensors. The conv biases that feed a train-mode BN have a gradient
that is zero in exact arithmetic (the BN subtracts the per-channel batch
mean they shift). In f64 both packages leave rounding noise there, up to
~3e-12 here (measured), and Adam's first update lr·g/(|g| + 1e-8) turns
noise of 3e-12 into a step of ~6e-7 whose sign is the noise's. Those
tensors are held to the most that formula gives from both packages'
gradients (per tensor), and the encoder's running means, which see the
shifted conv outputs of the finetune encode, to the bias difference;
everything else is held at atol 1e-8.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.models import gp as jgp
from dvg_tpu.models import layers as JL
from dvg_tpu.models.dcgan import decoder_apply_grouped
from dvg_tpu.models.dvg import DVGModel as JaxModel
from dvg_tpu.train import step as JS
from dvg_tpu.train.checkpoint import load_checkpoint as j_load
from dvg_tpu.train.checkpoint import save_checkpoint as j_save
from dvg_tpu.train.optim import gp_lr_schedule as j_gp_lr_schedule
from dvg_tpu.train.optim import make_optimizers as j_make_optimizers
from dvg_tpu.train.optim import split_params as j_split
from dvg_tpu_torch.checkpoint import (_state_dict, load_train_state,
                                      save_train_state)
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import params_from_jax, params_to_jax
from dvg_tpu_torch.models import gp as pgp
from dvg_tpu_torch.models import layers as L
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.train import (init_train_state, make_train_step,
                                 train_state)
from dvg_tpu_torch.train import step as PS

GEOM = dict(dataset="smmnist", channels=1, image_width=64, batch_size=2,
            n_past=2, n_future=1, n_eval=4, g_dim=8, rnn_size=16,
            num_inducing_points=4, epoch_size=3, ft=True)
ATOL = 1e-8            # the f64 step's bound
LR, EPS = 0.002, 1e-8  # Adam's lr and eps of the config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps this file's small CPU steps from
    oversubscribing the cores (it runs no slower alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noise_bias(name: str) -> bool:
    """A conv bias that feeds a train-mode BN (see the module docstring)."""
    return name.endswith("conv.bias") and not name.startswith(
        "decoder.final")


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def to_np(tree, dtype=None):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def perturbed_gp(params, seed=7):
    """The GP moved off its init (mean 0, L_S = I), where the GP-mean
    decode's BN would see a batch variance of exactly 0 and the kernel
    hyperparameters no gradient (tests/test_reference_source_parity.py's
    _perturb_gp)."""
    rng = np.random.RandomState(seed)
    gp = dict(params["gp"])
    d, m = gp["var_mean"].shape
    f = np.float32
    gp["mean_const"] = (0.05 * rng.randn(d)).astype(f)
    gp["var_mean"] = (0.2 * rng.randn(d, m)).astype(f)
    gp["var_chol"] = (np.asarray(gp["var_chol"])
                      + 0.1 * np.tril(rng.randn(d, m, m))).astype(f)
    gp["raw_lengthscale"] = (0.3 * rng.randn(d)).astype(f)
    gp["raw_outputscale"] = (0.3 * rng.randn(d)).astype(f)
    return dict(params, gp=gp)


def port_model(params, stats, cfg, dtype=torch.float64) -> DVGModel:
    model = DVGModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, cfg))
    return model.to(dtype)


def state_f64(state):
    """A TrainState converted to f64 in place: model and Adam moments."""
    state.model.double()
    for opt in state.opts.adam.values():
        for st in opt.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = st[k].double()
    return state


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}"))
    return out


@dataclasses.dataclass
class Ref:
    cfg: DVGConfig
    jcfg: JaxConfig
    model: object          # dvg_tpu DVGModel
    opts: object           # dvg_tpu Optimizers
    step_fn: object        # jitted f64 make_train_step_fn
    params: dict           # the init (f32 numpy)
    stats: dict
    x: np.ndarray          # (3, 2, 64, 64, 1) f64
    new: object            # TrainState after one f64 step (numpy)
    metrics: dict
    joint_loss: float
    joint_grads: dict      # f64, the JAX layout


def jax_state64(jcfg, opts, params, stats, opt_states=None, step=0):
    p, s = jax.tree.map(jnp.asarray, to_np(params, np.float64)), \
        jax.tree.map(jnp.asarray, to_np(stats, np.float64))
    if opt_states is None:
        groups = j_split(p)
        opt_states = {n: getattr(opts, n).init(groups[n]) for n in groups}
    else:
        opt_states = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(
                a, np.float64 if np.asarray(a).dtype.kind == "f" else None)),
            opt_states)
    return JS.TrainState(p, s, opt_states, jnp.asarray(step, jnp.int32))


def jax_skeleton(jcfg):
    """dvg_tpu's TrainState structure for load_checkpoint(target_state=…),
    traced, not computed."""
    return jax.eval_shape(lambda k: JS.init_train_state(jcfg, k)[1],
                          jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ref():
    """dvg_tpu's f64 step and joint gradients from the port's seeded init
    (the same law as dvg_tpu's) with a perturbed GP, on a seeded clip."""
    cfg, jcfg = DVGConfig(**GEOM), JaxConfig(**GEOM)
    model, opts = JaxModel(jcfg), j_make_optimizers(jcfg)
    params, stats = params_to_jax(DVGModel(cfg, device="cpu").state_dict(),
                                  cfg)
    params = perturbed_gp(params)
    x = np.random.RandomState(3).rand(3, 2, 64, 64, 1)
    with x64():
        step_fn = jax.jit(JS.make_train_step_fn(model, jcfg, opts))
        new, metrics = step_fn(jax_state64(jcfg, opts, params, stats),
                               jnp.asarray(x))
        new = JS.TrainState(*(to_np(t) for t in new))
        vg = jax.jit(lambda p, s, xx: jax.value_and_grad(
            JS.joint_loss, has_aux=True)(p, s, xx, model, jcfg))
        st = jax_state64(jcfg, opts, params, stats)
        (loss, _), grads = vg(st.params, st.stats, jnp.asarray(x))
    return Ref(cfg, jcfg, model, opts, step_fn, params, stats, x, new,
               {k: float(v) for k, v in metrics.items()}, float(loss),
               to_np(grads))


@pytest.fixture(scope="module")
def port(ref):
    """The port's f64 step from the same init, and its joint pass's
    gradients at the init (computed as the step computes them, on the
    channels_last model train_state makes, so that their rounding noise is
    the step's)."""
    model = train_state(port_model(ref.params, ref.stats, ref.cfg),
                        ref.cfg).model
    plan = PS.make_plan(ref.cfg, ref.x.shape[0], torch.device("cpu"))
    loss, *_ = PS.joint_loss(model, torch.from_numpy(ref.x), ref.cfg, plan)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    state = train_state(port_model(ref.params, ref.stats, ref.cfg), ref.cfg)
    state, metrics = make_train_step(ref.cfg)(state, ref.x)
    return state, {k: float(v) for k, v in metrics.items()}, grads


def test_bn_train_matches_batchnorm_apply():
    """Per-call train-mode BN (f32) against vmapped batchnorm_apply: the
    output, and the folded running stats of each call, atol 1e-5."""
    rng = np.random.RandomState(0)
    calls, b, h, w, c = 3, 4, 5, 6, 7
    y = (rng.randn(calls, b, h, w, c) * 2 + 0.5).astype(np.float32)
    p = {"scale": rng.rand(c).astype(np.float32) + 0.5,
         "bias": rng.randn(c).astype(np.float32)}
    s = {"mean": rng.randn(c).astype(np.float32),
         "var": rng.rand(c).astype(np.float32) + 0.5}
    out_j, new_j = jax.vmap(lambda yc: JL.batchnorm_apply(p, s, yc, True))(y)
    y_t = L.nchw(torch.from_numpy(y).flatten(0, 1))      # channels_last
    out_t, (mean, var) = L.batch_norm_train(
        y_t, torch.from_numpy(p["scale"]), torch.from_numpy(p["bias"]), calls)
    assert out_t.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(L.nhwc(out_t).reshape(y.shape).numpy(),
                               np.asarray(out_j), atol=1e-5)
    m = L.BN_MOMENTUM
    for key, raw in (("mean", mean), ("var", var)):
        np.testing.assert_allclose(
            (1 - m) * s[key] + m * raw.numpy(), np.asarray(new_j[key]),
            atol=1e-5)


def test_ema_fold_matches_sequential():
    """The closed-form fold equals r ← (1−m)·r + m·s_k applied call by
    call in the reference's order (encoder and decoder), and its weights
    equal dvg_tpu's."""
    rng = np.random.RandomState(0)
    m, seq_len, c = L.BN_MOMENTUM, 5, 7
    block = L.conv_block(3, c, 4, 2, 1).double()
    for order, n_slots in ((PS.encode_order(seq_len), seq_len),
                           (PS.decoder_call_order(PS.VARIANTS, seq_len - 1),
                            PS.VARIANTS * (seq_len - 1))):
        r0 = rng.rand(2, c)
        per = rng.rand(2, n_slots, c)
        ref = r0.copy()
        for j in order:
            ref = (1 - m) * ref + m * per[:, j]
        w, decay = PS.ema_weights(order, n_slots)
        with torch.no_grad():
            block.bn.running_mean.copy_(torch.from_numpy(r0[0]))
            block.bn.running_var.copy_(torch.from_numpy(r0[1]))
        PS.fold_stats([block], [(torch.from_numpy(per[0]),
                                 torch.from_numpy(per[1]))],
                      torch.from_numpy(w), decay)
        np.testing.assert_allclose(block.bn.running_mean.numpy(), ref[0],
                                   rtol=1e-12)
        np.testing.assert_allclose(block.bn.running_var.numpy(), ref[1],
                                   rtol=1e-12)
    w_enc, _ = PS.ema_weights(PS.encode_order(seq_len), seq_len)
    w_j, _ = JS._ema_weights(PS.encode_order(seq_len), seq_len, m)
    np.testing.assert_allclose(w_enc, np.asarray(w_j), rtol=1e-6)
    # dvg_tpu weights its variant-major decoder calls by the position
    # i·V + s of call s·(T−1) + i in the reference order
    v, tm1 = PS.VARIANTS, seq_len - 1
    n = v * tm1
    pos = np.array([i * v + s for s in range(v) for i in range(tm1)])
    w_dec, _ = PS.ema_weights(PS.decoder_call_order(v, tm1), n)
    np.testing.assert_allclose(w_dec, m * (1 - m) ** (n - 1 - pos),
                               rtol=1e-12)


def test_grouped_decoder_matches_decoder_apply_grouped(ref):
    """Decoder.grouped against decoder_apply_grouped (f32) at T 6, n_past
    3: 15 calls sharing 2 unique skip frames. Frames and each call's
    folded statistics, atol 1e-5."""
    cfg = DVGConfig(**dict(GEOM, n_past=3, n_future=3, n_eval=8))
    params, stats = ref.params, ref.stats
    t = cfg.seq_len_train
    rng = np.random.RandomState(2)
    idx = JS.skip_index(t, cfg.n_past, False)
    uniq, inv = np.unique(idx, return_inverse=True)
    gi = np.tile(inv, 3)
    lat = rng.uniform(-1, 1, (3 * (t - 1), 2, cfg.g_dim)).astype(np.float32)
    # skips of the unique frames: leaky_relu outputs of the encoder stages
    skips_u = [rng.randn(len(uniq), 2, 64 // 2 ** (i + 1), 64 // 2 ** (i + 1),
                         64 * 2 ** i).astype(np.float32) for i in range(4)]
    frames_j, stats_j = jax.jit(lambda p, s, v, sk: decoder_apply_grouped(
        p, s, v, sk, gi, train=True))(params["decoder"], stats["decoder"],
                                      lat, skips_u)

    pm = port_model(params, stats, cfg, torch.float32)
    frames_t, stats_t = pm.decoder.grouped(
        torch.from_numpy(lat), [torch.from_numpy(s) for s in skips_u],
        torch.from_numpy(gi))
    assert len(np.unique(gi)) == cfg.n_past - 1 < len(gi)
    np.testing.assert_allclose(frames_t.detach().numpy(),
                               np.asarray(frames_j), atol=1e-5)
    m = L.BN_MOMENTUM
    blocks_j = [stats_j["head"]] + stats_j["stages"]
    base = [stats["decoder"]["head"]] + stats["decoder"]["stages"]
    for bj, b0, (mean, var) in zip(blocks_j, base, stats_t):
        for key, raw in (("mean", mean), ("var", var)):
            np.testing.assert_allclose(
                (1 - m) * b0["bn"][key] + m * raw.numpy(),
                np.asarray(bj["bn"][key]), atol=1e-5)


def test_gp_posterior_kl_elbo_values_and_grads_f64(ref):
    """posterior / kl_divergence / elbo over a (T−1, D, B) batch, and the
    gradient of Σ elbo in every GP parameter and in x, against jax.grad in
    f64: rtol 1e-10."""
    gp64 = to_np(ref.params["gp"], np.float64)
    lik64 = to_np(ref.params["likelihood"], np.float64)
    rng = np.random.RandomState(5)
    x = rng.randn(4, 8, 6, 1) * 0.5
    y = rng.randn(4, 8, 6) * 0.5
    with x64():
        def total(gp, lik, xx):
            return jnp.sum(jax.vmap(lambda a, b: jgp.elbo(
                gp, lik, a, b, num_data=6))(xx, y))
        val, (g_gp, g_lik, g_x) = jax.jit(jax.value_and_grad(
            total, (0, 1, 2)))(gp64, lik64, jnp.asarray(x))
        post = jax.jit(jax.vmap(lambda a: jgp.posterior(gp64, a)))(
            jnp.asarray(x))
        kl = jax.jit(jgp.kl_divergence)(gp64)
        val, post, kl, g_gp, g_lik, g_x = to_np(
            (val, (post.mean, post.var), kl, g_gp, g_lik, g_x))

    model = port_model(ref.params, ref.stats, ref.cfg)
    xt = torch.tensor(x, requires_grad=True)
    out = pgp.elbo(model.gp, model.likelihood, xt, torch.from_numpy(y), 6)
    out.sum().backward()
    p = pgp.posterior(model.gp, xt)
    np.testing.assert_allclose(out.sum().item(), val, rtol=1e-10)
    np.testing.assert_allclose(p.mean.detach().numpy(), post[0], rtol=1e-10)
    np.testing.assert_allclose(p.var.detach().numpy(), post[1], rtol=1e-10)
    np.testing.assert_allclose(pgp.kl_divergence(model.gp).detach().numpy(),
                               kl, rtol=1e-10)
    np.testing.assert_allclose(xt.grad.numpy(), g_x, rtol=1e-10, atol=1e-14)
    for k, g in g_gp.items():
        np.testing.assert_allclose(getattr(model.gp, k).grad.numpy(), g,
                                   rtol=1e-10, atol=1e-14, err_msg=k)
    np.testing.assert_allclose(model.likelihood.raw_noise.grad.numpy(),
                               g_lik["raw_noise"], rtol=1e-10, atol=1e-14)


def test_joint_loss_value_and_grads_f64(ref, port):
    """The joint pass's loss and every parameter's gradient against
    jax.value_and_grad(joint_loss) in f64. Real gradients agree to
    ‖Δg‖/‖g‖ ≤ 1e-10 (measured ≤ 2.6e-13); a noise bias's gradient is
    below 1e-10 in both packages (measured ≤ 3.2e-12, where the smallest
    real gradient tensor reaches 6.4e-8)."""
    _, metrics, grads = port
    np.testing.assert_allclose(metrics["loss"], ref.joint_loss, rtol=1e-12)
    want = params_from_jax(ref.joint_grads, ref.stats, ref.cfg)
    assert grads.keys() == want.keys() - {
        k for k in want if "running" in k or "num_batches" in k}
    for k, g in grads.items():
        r = want[k]
        if noise_bias(k):
            assert g.abs().max() < 1e-10 and r.abs().max() < 1e-10, k
        else:
            assert ((g - r).norm() / r.norm()).item() <= 1e-10, k


def assert_state_close(state, params, stats, opt_states, grads=None,
                       atol=ATOL, cfg=None):
    """The port's state against a dvg_tpu TrainState's params, stats and
    opt_states (numpy, JAX layouts). Noise biases: within
    lr·(max|g_port| + max|g_jax|)/eps, the most Adam's first update can
    move a parameter with such gradients in either package, when the
    step's gradients are given, else within one Adam step (lr); the
    encoder's running means within the bias difference of their block.
    `cfg` defaults to the module's tiny config."""
    cfg = cfg or DVGConfig(**GEOM)
    want = params_from_jax(params, stats, cfg)
    got = state.model.state_dict()
    bias_err = {}
    for k, v in want.items():
        if "num_batches" in k:
            continue
        d = (got[k].double() - v.double()).abs()
        if noise_bias(k):
            bound = LR if grads is None else (
                LR * (grads[0][k].abs().max() + grads[1][k].abs().max())
                / EPS + atol)
            assert bool((d <= bound).all()), (k, d.max().item())
            if k.startswith("encoder"):
                bias_err[k.replace("conv.bias", "bn.running_mean")] = d
        elif k in bias_err:
            assert bool((d <= bias_err[k] + atol).all()), (k, d.max().item())
        else:
            assert d.max().item() <= atol, (k, d.max().item())
    got_opt = leaves(_state_dict(state.opts.to_jax(state.model, cfg)))
    want_opt = leaves(serialization.to_state_dict(opt_states))
    assert got_opt.keys() == want_opt.keys()
    for k in want_opt:
        if k.endswith("count"):
            assert int(got_opt[k]) == int(want_opt[k]), k
        else:
            np.testing.assert_allclose(got_opt[k], want_opt[k], rtol=0,
                                       atol=atol, err_msg=k)


def test_one_step_matches_make_train_step_fn_f64(ref, port):
    """One whole step (joint + both finetune passes) from the same init in
    f64: metrics rtol 1e-9 (measured ≤ 1.2e-15), every parameter, BN
    statistic and Adam moment at atol 1e-8 (measured ≤ 2.1e-10 outside the
    noise tensors; the noise biases moved 5.6e-7)."""
    state, metrics, grads = port
    assert metrics.keys() == ref.metrics.keys()
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-9, err_msg=k)
    assert state.step == int(ref.new.step) == 1
    g_j = params_from_jax(ref.joint_grads, ref.stats, ref.cfg)
    assert_state_close(state, ref.new.params, ref.new.stats,
                       ref.new.opt_states, grads=(grads, g_j))
    # the step moved every group
    init = port_model(ref.params, ref.stats, ref.cfg).state_dict()
    for k in ("encoder.head.conv.weight", "decoder.final.weight",
              "frame_predictor.cells.0.weight_hh", "gp.z",
              "likelihood.raw_noise"):
        assert (state.model.state_dict()[k] - init[k]).abs().max() > 1e-4, k


TRAJECTORY = dict(epoch_size=1, gp_lr_milestones=(2, 3))
TRAJECTORY_RTOL = 1e-7
# a weight whose path passes near 0 carries the steps' rounding (~1e-11)
# beside a value that rtol alone would hold to ~1e-13
TRAJECTORY_ATOL = 1e-10


def test_trajectory_across_gp_milestones_f64(ref):
    """Three f64 steps on three clips at epoch_size 1 with the GP milestones
    at epochs 2 and 3, so the GP group's rate decays twice inside the run
    (2e-3, 2e-4, 2e-5), against make_train_step_fn from the same init.
    After every step: each parameter of the four groups at rtol 1e-7 and
    atol 1e-10 (the noise biases of the module docstring within two Adam
    rates per step taken), and the rate of the GP
    group's last update equal to dvg_tpu's schedule at its own update
    count."""
    cfg, jcfg = ref.cfg.replace(**TRAJECTORY), ref.jcfg.replace(**TRAJECTORY)
    opts = j_make_optimizers(jcfg)
    xs = np.random.RandomState(21).rand(3, *ref.x.shape)
    state = train_state(port_model(ref.params, ref.stats, cfg), cfg)
    step = make_train_step(cfg)
    sched = j_gp_lr_schedule(jcfg)
    rates = []
    with x64():
        step_fn = jax.jit(JS.make_train_step_fn(JaxModel(jcfg), jcfg, opts))
        jstate = jax_state64(jcfg, opts, ref.params, ref.stats)
        for k, x in enumerate(xs):
            jstate, _ = step_fn(jstate, jnp.asarray(x))
            step(state, x)
            new = JS.TrainState(*(to_np(t) for t in jstate))
            want = params_from_jax(new.params, new.stats, cfg)
            for name, p in state.model.named_parameters():
                got, w = p.detach().numpy(), want[name].numpy()
                if noise_bias(name):
                    assert np.abs(got - w).max() <= 2 * LR * (k + 1), name
                else:
                    np.testing.assert_allclose(got, w,
                                               rtol=TRAJECTORY_RTOL,
                                               atol=TRAJECTORY_ATOL,
                                               err_msg=name)
            count = int(new.opt_states["gp_group"][1].count)
            assert count == state.opts.counts["gp_group"] == 2 * (k + 1)
            rate = state.opts.adam["gp_group"].param_groups[0]["lr"]
            assert np.float32(rate) == np.float32(sched((count - 1) // 2))
            rates.append(rate)
    np.testing.assert_allclose(rates, [2e-3, 2e-4, 2e-5], rtol=1e-6)


def test_bf16_step_losses_within_measured_band(ref):
    """cfg.dtype bfloat16 from the same f32 init: the port's step metrics
    against dvg_tpu's bf16 step. The finetune losses follow the joint
    update, whose first Adam step takes the sign of every near-zero
    gradient, and bf16 moves those: dvg_tpu's own bf16 step differs from
    its f32 step by 1.4e-2 on ft_gp_nll and 2.2e-3 on ft_mse_latent
    (measured); the port's bf16 step differs from dvg_tpu's by 1.4e-2 on
    ft_gp_nll, 1.1e-3 on ft_mse_latent and ≤ 8.4e-5 on the rest
    (measured). Band: rtol 5e-2 on the latent terms, 1e-3 on the frame
    terms; the losses are f32 and finite."""
    geom = dict(GEOM, dtype="bfloat16")
    cfg, jcfg = DVGConfig(**geom), JaxConfig(**geom)
    model, opts = JaxModel(jcfg), j_make_optimizers(jcfg)
    x = ref.x.astype(np.float32)
    st = JS.TrainState(jax.tree.map(jnp.asarray, ref.params),
                       jax.tree.map(jnp.asarray, ref.stats),
                       {n: getattr(opts, n).init(g) for n, g in
                        j_split(jax.tree.map(jnp.asarray,
                                             ref.params)).items()},
                       jnp.zeros((), jnp.int32))
    _, jm = jax.jit(JS.make_train_step_fn(model, jcfg, opts))(
        st, jnp.asarray(x))
    state = train_state(port_model(ref.params, ref.stats, cfg,
                                   torch.float32), cfg)
    _, pm = make_train_step(cfg)(state, x)
    latent = ("mse_latent", "mse_latent_per_frame", "max_ll",
              "ft_mse_latent", "ft_gp_nll")
    for k, v in jm.items():
        assert pm[k].dtype == torch.float32 and torch.isfinite(pm[k]), k
        np.testing.assert_allclose(pm[k].item(), float(v),
                                   rtol=5e-2 if k in latent else 1e-3,
                                   err_msg=k)


def _joint_grads(cfg, jcfg, params, stats, x):
    """The joint pass's gradients of both packages at (params, stats) on x,
    in cfg.dtype, in the port's names: (port, dvg_tpu)."""
    model = train_state(port_model(params, stats, cfg, torch.float32),
                        cfg).model
    plan = PS.make_plan(cfg, x.shape[0], torch.device("cpu"))
    loss, *_ = PS.joint_loss(model, torch.from_numpy(x), cfg, plan)
    loss.backward()
    jmodel = JaxModel(jcfg)
    _, g = jax.jit(lambda p, s, xx: jax.value_and_grad(
        JS.joint_loss, has_aux=True)(p, s, xx, jmodel, jcfg))(
        *(jax.tree.map(jnp.asarray, t) for t in (params, stats)),
        jnp.asarray(x))
    return ({k: p.grad for k, p in model.named_parameters()},
            params_from_jax(to_np(g), stats, cfg))


def test_bf16_output_bias_gradient_tracks_f32(ref):
    """cfg.dtype bfloat16: the gradient of the decoder's output bias (the
    one conv bias with no BN after it, so a wrong gradient moves every
    generated frame) stays within 2% of the f32 step's, with the port's
    own f32 step as the reference (the two packages' f32 gradients agree
    to 1e-4 here). dvg_tpu's bf16 gradient is printed beside it: its
    autodiff sums the bf16 cotangent of the bias add in bf16, which on
    XLA:CPU rounds partial sums (at the recipe's widths and seeded init,
    B 8: 89% off f32, the port 0.4%; `python tests/train_side_by_side.py
    --bias_grads --batch 8`)."""
    x = ref.x.astype(np.float32)
    grads = {}
    for dt in ("float32", "bfloat16"):
        geom = dict(GEOM, dtype=dt)
        grads[dt] = _joint_grads(DVGConfig(**geom), JaxConfig(**geom),
                                 ref.params, ref.stats, x)
    k = "decoder.final.bias"
    want = grads["float32"][0][k].double()
    np.testing.assert_allclose(grads["float32"][1][k].double(), want,
                               rtol=1e-4)
    errs = {n: ((grads["bfloat16"][i][k].double() - want).norm()
                / want.norm()).item() for i, n in enumerate(("port",
                                                             "dvg_tpu"))}
    print(f"decoder.final.bias gradient, bf16 against f32: port "
          f"{errs['port']:.2e}, dvg_tpu {errs['dvg_tpu']:.2e} (|g| "
          f"{want.norm().item():.3e})")
    assert errs["port"] <= 2e-2


def test_port_train_state_resumes_in_dvg_tpu(ref, tmp_path):
    """A TrainState the port wrote (after one f32 step) loads in
    dvg_tpu.train.load_checkpoint(target_state=…); from it, dvg_tpu's next
    step and the port's next step (both in f64) agree."""
    cfg = ref.cfg
    state = train_state(port_model(ref.params, ref.stats, cfg,
                                   torch.float32), cfg)
    step = make_train_step(cfg)
    step(state, ref.x.astype(np.float32))
    path = save_train_state(str(tmp_path), cfg, state)

    jcfg, loaded = j_load(path, target_state=jax_skeleton(ref.jcfg))
    assert jcfg == ref.jcfg and int(loaded.step) == 1
    with x64():
        new, _ = ref.step_fn(jax_state64(
            jcfg, ref.opts, to_np(loaded.params), to_np(loaded.stats),
            to_np(loaded.opt_states), 1), jnp.asarray(ref.x))
        new = JS.TrainState(*(to_np(t) for t in new))
    _, port_state = load_train_state(path, device="cpu")
    port_state = state_f64(port_state)
    step(port_state, ref.x)
    assert port_state.step == int(new.step) == 2
    assert_state_close(port_state, new.params, new.stats, new.opt_states)


def test_dvg_tpu_train_state_resumes_in_port(ref, tmp_path):
    """A TrainState dvg_tpu wrote (its step from the init, stored in f32)
    loads in the port with its optimizer state; the port's next step and
    dvg_tpu's (both in f64) agree."""
    f32 = lambda t: jax.tree.map(
        lambda a: np.asarray(a, np.float32) if np.asarray(a).dtype.kind == "f"
        else np.asarray(a), t)
    saved = JS.TrainState(f32(ref.new.params), f32(ref.new.stats),
                          f32(ref.new.opt_states), np.asarray(1, np.int32))
    path = j_save(str(tmp_path), ref.jcfg, saved)
    cfg, state = load_train_state(path, device="cpu")
    assert cfg == ref.cfg and state.step == 1
    assert state.opts.counts == {"frame_predictor": 2, "encoder": 1,
                                 "decoder": 1, "gp_group": 2}
    state = state_f64(state)
    make_train_step(cfg)(state, ref.x)
    with x64():
        new, _ = ref.step_fn(jax_state64(
            ref.jcfg, ref.opts, saved.params, saved.stats,
            saved.opt_states, 1), jnp.asarray(ref.x))
        new = JS.TrainState(*(to_np(t) for t in new))
    assert_state_close(state, new.params, new.stats, new.opt_states)


def test_resume_is_exact(ref, tmp_path):
    """Two port steps equal one step, a save and a load, then one step,
    bit for bit (f32, CPU)."""
    cfg = ref.cfg.replace(seed=4)
    xs = np.random.RandomState(11).rand(2, 3, 2, 64, 64, 1).astype(
        np.float32)
    step = make_train_step(cfg)
    a = init_train_state(cfg, device="cpu")
    for x in xs:
        _, ma = step(a, x)
    b = init_train_state(cfg, device="cpu")
    step(b, xs[0])
    path = save_train_state(str(tmp_path / "run"), cfg, b)
    _, b = load_train_state(path, device="cpu")
    _, mb = step(b, xs[1])
    assert a.step == b.step == 2 and a.opts.counts == b.opts.counts
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    got, want = (leaves(_state_dict(s.opts.to_jax(s.model, cfg)))
                 for s in (b, a))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_remat_gives_the_same_step(ref):
    """cfg.remat recomputes the encoder's and decoder's activations in the
    backward (torch.utils.checkpoint): the same step, bit for bit on the
    CPU."""
    x = ref.x.astype(np.float32)
    states = []
    for cfg in (ref.cfg, ref.cfg.replace(remat=True)):
        state = train_state(port_model(ref.params, ref.stats, cfg,
                                       torch.float32), cfg)
        _, metrics = make_train_step(cfg)(state, x)
        states.append((state.model.state_dict(), metrics))
    (sd_a, m_a), (sd_b, m_b) = states
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k


def test_model_builds_with_gradients_and_step_raises_without_card(ref):
    """The model now trains (requires_grad on); the step's entry points
    default to the card and raise without one."""
    model = DVGModel(ref.cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(ref.cfg)
