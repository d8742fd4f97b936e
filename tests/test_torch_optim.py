"""The port's optimizers (`dvg_tpu_torch.train.optim`) against
`dvg_tpu.train.optim` on the CPU, at the tiny config of tests/test_train.py:
the GP learning-rate schedule per step and per epoch; the four Adam groups
applied to identical gradients (f64) over steps that cross both GP
milestones, against optax; the checkpoint layout of their state against
optax's; beta1 on the three groups that take it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.train import optim as JO
from dvg_tpu_torch.checkpoint import _lists, _state_dict
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import params_from_jax, params_to_jax
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.train import optim as PO

GEOM = dict(dataset="smmnist", channels=1, image_width=64, batch_size=2,
            n_past=2, n_future=1, n_eval=4, g_dim=8, rnn_size=16,
            num_inducing_points=4, epoch_size=3, ft=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps this file's small CPU steps from
    oversubscribing the cores (it runs no slower alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("milestones,gamma", [((3, 5), 0.1), ((1, 2, 4), 0.5)])
def test_gp_lr_schedule_matches_dvg_tpu(milestones, gamma):
    """The rate at every step of eight epochs equals dvg_tpu's to the bit
    (both round it in f32), and .at_epoch equals dvg_tpu's."""
    geom = dict(GEOM, epoch_size=4, gp_lr_milestones=milestones,
                gp_lr_gamma=gamma)
    port = PO.gp_lr_schedule(DVGConfig(**geom))
    ref = JO.gp_lr_schedule(JaxConfig(**geom))
    for step in range(8 * 4):
        assert port(step) == float(ref(jnp.asarray(step))), step
    for epoch in range(8):
        assert port.at_epoch(epoch) == pytest.approx(ref.at_epoch(epoch),
                                                     rel=1e-15)


def test_adam_groups_match_optax_on_identical_gradients():
    """Per batch: the joint update of all four groups, then the two
    finetune updates (frame_predictor, gp_group), from identical f64
    gradients, for 3 batches at epoch_size 1 and milestones (2, 3), so the
    GP rate decays at epochs 1 and 2. Parameters and moments against optax
    at atol 1e-12 (random gradients: none near Adam's eps)."""
    geom = dict(GEOM, epoch_size=1, beta1=0.5, gp_lr_milestones=(2, 3))
    cfg, jcfg = DVGConfig(**geom), JaxConfig(**geom)
    model = DVGModel(cfg, seed=2, device="cpu").double()
    opts = PO.Optimizers(cfg, model)
    rng = np.random.RandomState(0)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        params, stats = params_to_jax(model.state_dict(), cfg)
        jopts = JO.make_optimizers(jcfg)
        groups = jax.tree.map(jnp.asarray, JO.split_params(params))
        states = {n: getattr(jopts, n).init(groups[n]) for n in groups}

        @functools.partial(jax.jit, static_argnums=3)
        def apply(g, state, params, name_idx):
            name = PO.MODULE_GROUPS[name_idx]
            upd, state = getattr(jopts, name).update(g, state, params)
            return optax.apply_updates(params, upd), state

        def update(name, grads_sd):
            g = JO.split_params(params_to_jax(grads_sd, cfg)[0])[name]
            groups[name], states[name] = apply(
                g, states[name], groups[name], PO.MODULE_GROUPS.index(name))
            for p_name, p in zip(opts.names[name], opts.params(name)):
                p.grad = grads_sd[p_name].clone()
            opts.step(name)

        for _ in range(3):
            for names in (PO.MODULE_GROUPS, ("frame_predictor",),
                          ("gp_group",)):
                sd = {k: torch.from_numpy(rng.randn(*v.shape))
                      if v.is_floating_point() else v
                      for k, v in model.state_dict().items()}
                for n in names:
                    update(n, sd)
        want_params = JO.merge_params(groups)
        want_opt = serialization.to_state_dict(
            jax.tree.map(np.asarray, states))
    finally:
        jax.config.update("jax_enable_x64", prev)
    got = leaves(_state_dict(params_to_jax(model.state_dict(), cfg)[0]))
    want = leaves(_state_dict(jax.tree.map(np.asarray, want_params)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    got_opt = leaves(_state_dict(opts.to_jax(model, cfg)))
    want_opt = leaves(want_opt)
    assert got_opt.keys() == want_opt.keys()
    for k in want_opt:
        np.testing.assert_allclose(got_opt[k], want_opt[k], rtol=0,
                                   atol=1e-12, err_msg=k)
    assert opts.counts == {"frame_predictor": 6, "encoder": 3,
                           "decoder": 3, "gp_group": 6}
    assert opts.adam["gp_group"].param_groups[0]["lr"] == PO.gp_lr_schedule(
        cfg)(2) == pytest.approx(2e-5, rel=1e-6)


def test_opt_state_layout_is_optax_and_round_trips():
    """A fresh and a stepped Optimizers in optax's checkpoint layout: the
    same key paths, shapes and dtypes as dvg_tpu's optimizers' init state
    (what init_train_state holds); and load_jax gives back the same
    state."""
    cfg, jcfg = DVGConfig(**GEOM), JaxConfig(**GEOM)
    model = DVGModel(cfg, seed=1, device="cpu")
    jopts = JO.make_optimizers(jcfg)
    groups = JO.split_params(params_to_jax(model.state_dict(), cfg)[0])
    want = leaves(serialization.to_state_dict(jax.tree.map(
        np.asarray, {n: getattr(jopts, n).init(groups[n]) for n in groups})))
    opts = PO.Optimizers(cfg, model)
    got = leaves(_state_dict(opts.to_jax(model, cfg)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    for g in PO.MODULE_GROUPS:
        opts.step(g)
    tree = _state_dict(opts.to_jax(model, cfg))
    other = PO.Optimizers(cfg, model)
    _, stats = params_to_jax(model.state_dict(), cfg)
    other.load_jax(_lists(tree), stats, cfg)
    assert other.counts == opts.counts
    for g in PO.MODULE_GROUPS:
        for p in opts.params(g):
            a, b = opts.adam[g].state[p], other.adam[g].state[p]
            assert float(a["step"]) == float(b["step"]) == 1.0
            assert torch.equal(a["exp_avg"], b["exp_avg"])
            assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    # a file whose schedule count disagrees with its Adam count is refused
    bad = _lists(tree)
    bad["gp_group"][1]["count"] = np.asarray(5, np.int32)
    with pytest.raises(ValueError, match="schedule count"):
        other.load_jax(bad, stats, cfg)


def test_beta1_and_groups():
    """--beta1 reaches the frame_predictor, encoder and decoder groups; the
    GP group keeps b1 0.9 and the GP rate; the groups cover every
    parameter once."""
    cfg = DVGConfig(**dict(GEOM, beta1=0.5, lr=1e-3, gp_lr=3e-3))
    model = DVGModel(cfg, device="cpu")
    opts = PO.Optimizers(cfg, model)
    for g in ("frame_predictor", "encoder", "decoder"):
        pg = opts.adam[g].param_groups[0]
        assert pg["betas"] == (0.5, 0.999) and pg["lr"] == 1e-3
        assert pg["eps"] == 1e-8
    pg = opts.adam["gp_group"].param_groups[0]
    assert pg["betas"] == (0.9, 0.999) and pg["lr"] == 3e-3
    names = [n for g in PO.MODULE_GROUPS for n in opts.names[g]]
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    assert sorted(params_from_jax(*params_to_jax(model.state_dict(), cfg),
                                  cfg)) == sorted(model.state_dict())
