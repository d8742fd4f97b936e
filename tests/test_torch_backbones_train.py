"""The port's train step on the backbones beyond DCGAN-64 against
`dvg_tpu`'s, on the CPU, at the training config of tests/test_torch_train.py
(C 1, B 2, g_dim 8) cut to T 2, for VGG-64 and DCGAN-128 (VGG-128 shares
VGG-64's code and runs card against CPU in chip_smoke.py): a TrainState
`dvg_tpu` wrote, with moments and update counts of a run under way,
resumed by the port under the run's config, whose next f64 step equals
`make_train_step_fn`'s at atol 1e-8 (that file's rule for the conv biases
that feed a train-mode BN); the port's TrainState after it read by
`dvg_tpu.train.load_checkpoint(target_state=…)` with every leaf equal.

The step also holds the train-mode encode, in f64: in f32 each package's
train-mode VGG-64 encode sits ~5e-5 from its own f64 result at B 4
(measured; the two f64 results agree to 3e-13), the per-frame BN over a
small batch amplifying rounding, as tests/test_torch_train.py finds for
DCGAN-64. The step is cut to T 2 because XLA:CPU's f64 convolutions run
at ~3.4 GFLOP/s on an 8-core Intel Xeon (f32: ~65): VGG-64's step at T 3
took 70 s there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.models.dvg import DVGModel as JaxModel
from dvg_tpu.train import checkpoint as jckpt
from dvg_tpu.train import step as JS
from dvg_tpu.train.optim import make_optimizers as j_make_optimizers
from dvg_tpu.train.optim import split_params as j_split
from dvg_tpu_torch.checkpoint import load_train_state, save_train_state
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import params_to_jax
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.train import make_train_step
from test_torch_backbones import BACKBONES, _leaves
from test_torch_train import (GEOM, assert_state_close, jax_skeleton,
                              jax_state64, perturbed_gp, state_f64, to_np,
                              x64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker of the multi-worker suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# update counts of the written TrainState: two batches into a run with the
# finetune passes on (two updates a batch for the LSTM and the GP group)
COUNTS = {"frame_predictor": 4, "encoder": 2, "decoder": 2, "gp_group": 4}


def running_opt_states(opts, params, seed):
    """Optimizer states of a run under way, in optax's structure: every
    group's count, first moments ~N(0, 1e-3²) and second moments
    ~U(0, 1e-6), f32."""
    rng = np.random.RandomState(seed)
    groups = j_split(jax.tree.map(jnp.asarray, params))
    states = {n: getattr(opts, n).init(groups[n]) for n in groups}

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith(".count"):
            return np.asarray(COUNTS[name.split("'")[1]], np.int32)
        if ".mu" in name:
            return (1e-3 * rng.randn(*a.shape)).astype(np.float32)
        return (1e-6 * rng.rand(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, states)


@pytest.fixture(scope="module", params=["vgg64", "dcgan128"])
def resumed(request, tmp_path_factory):
    """A TrainState `dvg_tpu` wrote (the port's seeded init with a
    perturbed GP, f32, running optimizer states, step 2) and dvg_tpu's
    jitted f64 step from it; the port's f64 step from the same file,
    resumed under the run's config."""
    geom = dict(GEOM, n_past=1, n_future=1, **BACKBONES[request.param])
    cfg, jcfg = DVGConfig(**geom), JaxConfig(**geom)
    model, opts = JaxModel(jcfg), j_make_optimizers(jcfg)
    params, stats = params_to_jax(DVGModel(cfg, device="cpu").state_dict(),
                                  cfg)
    params = perturbed_gp(params)
    saved = JS.TrainState(params, stats,
                          running_opt_states(opts, params, seed=8),
                          np.asarray(2, np.int32))
    path = jckpt.save_checkpoint(str(tmp_path_factory.mktemp("jax")), jcfg,
                                 saved)
    x = np.random.RandomState(3).rand(2, 2, cfg.image_width,
                                      cfg.image_width, 1)
    with x64():
        new, metrics = jax.jit(JS.make_train_step_fn(model, jcfg, opts))(
            jax_state64(jcfg, opts, params, stats, saved.opt_states, 2),
            jnp.asarray(x))
        new = JS.TrainState(*(to_np(t) for t in new))
    saved_cfg, state = load_train_state(path, cfg, device="cpu")
    assert saved_cfg == cfg and state.step == 2
    assert state.opts.counts == COUNTS
    state, port_metrics = make_train_step(cfg)(state_f64(state), x)
    return dict(name=request.param, cfg=cfg, jcfg=jcfg, path=path, new=new,
                metrics={k: float(v) for k, v in metrics.items()},
                state=state,
                port_metrics={k: float(v) for k, v in port_metrics.items()})


def test_resumed_step_matches_make_train_step_fn_f64(resumed):
    """From the TrainState dvg_tpu wrote, one whole step (joint + both
    finetune passes) in f64: metrics rtol 1e-9; every parameter, BN
    statistic, Adam moment and count at atol 1e-8, the BN-fed conv biases
    within one Adam step."""
    r = resumed
    assert r["port_metrics"].keys() == r["metrics"].keys()
    for k, v in r["metrics"].items():
        np.testing.assert_allclose(r["port_metrics"][k], v, rtol=1e-9,
                                   err_msg=k)
    assert r["state"].step == int(r["new"].step) == 3
    assert_state_close(r["state"], r["new"].params, r["new"].stats,
                       r["new"].opt_states, cfg=r["cfg"])


def test_port_train_state_loads_in_dvg_tpu(resumed, tmp_path):
    """The port's TrainState after that step, written by the port, loads in
    `dvg_tpu.train.load_checkpoint(target_state=…)` with every parameter,
    statistic, moment and count equal to the port's, and step 3."""
    r = resumed
    state, cfg = r["state"], r["cfg"]
    path = save_train_state(str(tmp_path), cfg, state)
    jcfg, loaded = jckpt.load_checkpoint(
        path, target_state=jax_skeleton(r["jcfg"]))
    assert jcfg == r["jcfg"] and int(loaded.step) == 3
    params, stats = params_to_jax(state.model.state_dict(), cfg)
    want = _leaves({"params": params, "stats": stats,
                    "opt_states": serialization.to_state_dict(
                        state.opts.to_jax(state.model, cfg))})
    got = _leaves({"params": to_np(loaded.params),
                   "stats": to_np(loaded.stats),
                   "opt_states": serialization.to_state_dict(
                       to_np(loaded.opt_states))})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    counts = {g: int(loaded.opt_states[g][0].count) for g in COUNTS}
    assert counts == {g: c + (2 if c == 4 else 1)
                      for g, c in COUNTS.items()}


def test_a_train_state_that_does_not_fit_the_run_raises(resumed):
    """The file's leaves under a run's config of another width or backbone
    raise, naming what does not fit, instead of rebuilding from the
    file's config."""
    cfg = resumed["cfg"]
    with pytest.raises(RuntimeError, match="size mismatch for encoder.head"):
        load_train_state(resumed["path"], cfg.replace(g_dim=4), device="cpu")
    other = "dcgan" if cfg.model == "vgg" else "vgg"
    with pytest.raises(ValueError, match=f"model='{other}'"):
        load_train_state(resumed["path"], cfg.replace(model=other),
                         device="cpu")
