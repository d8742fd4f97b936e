"""The modules no `dvg_tpu` path calls, ported for capability parity
(`dvg_tpu_torch.models.rnn`'s gru, rnn and gaussian_lstm predictors,
`models.vgg.GaussianEncoder`, `models.classifiers`): forward parity against
`dvg_tpu` on the same weights (`dvg_tpu`'s init, mapped by
`convert.predictor_from_jax`, `gaussian_encoder_from_jax` and
`classifier_from_jax`), f32, atol 1e-5. The Gaussian heads take the eps
`dvg_tpu` draws from its rng; BatchNorm runs on random running
statistics in eval mode (the port's Gaussian encoder folds them into its
trunk's convs first) and on the batch's in train mode (no dropout,
as `dvg_tpu` drops out only with an rng); the train-mode Gaussian
encoder's skips at 5e-5 (TRAIN_SKIP_ATOL). Dropout draws only from the
generator it is given."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvg_tpu.models import classifiers as jcls
from dvg_tpu.models import rnn as jrnn
from dvg_tpu.models import vgg as jvgg
from dvg_tpu_torch.convert import (classifier_from_jax,
                                   gaussian_encoder_from_jax,
                                   predictor_from_jax)
from dvg_tpu_torch.models.classifiers import (MLP, MLP2, CNNBlockFrame,
                                              CNNBlockFrame3)
from dvg_tpu_torch.models.rnn import (GaussianLSTMPredictor, GRUPredictor,
                                      RNNPredictor)
from dvg_tpu_torch.models.vgg import GaussianEncoder

ATOL = 1e-5
# the train-mode trunk renormalizes each of its blocks by the statistics of
# a 2-image batch, and the two frameworks reduce in other orders: its
# unit-scale skips differ by up to 1.8e-5 (measured), so they are held to
# 5e-5 beside the 1e-5 of every head output
TRAIN_SKIP_ATOL = 5e-5
B, IN, OUT, H, LAYERS, STEPS = 3, 12, 10, 32, 2, 3


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _random_stats(stats, seed):
    """Running statistics away from their init: mean N(0, 0.1), var
    U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        return jnp.asarray(rng.normal(0, 0.1, a.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, stats)


@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_gru_and_rnn_predictors(kind):
    init, apply, hidden_init = (getattr(jrnn, f"{kind}_{f}")
                                for f in ("init", "apply", "hidden_init"))
    params = init(jax.random.PRNGKey(1), IN, OUT, H, LAYERS)
    port = {"gru": GRUPredictor, "rnn": RNNPredictor}[kind](IN, OUT, H,
                                                            LAYERS)
    port.load_state_dict(predictor_from_jax(params))
    xs = np.random.RandomState(2).randn(STEPS, B, IN).astype(np.float32)
    jh = hidden_init(B, H, LAYERS)
    ph = port.hidden_init(B, torch.float32, "cpu")
    for x in xs:
        jout, jh = apply(params, jh, jnp.asarray(x))
        pout, ph = port(ph, torch.from_numpy(x))
        _close(pout, jout)
        _close(ph, jh)


def test_gaussian_lstm_predictor():
    params = jrnn.gaussian_lstm_init(jax.random.PRNGKey(3), IN, OUT, H,
                                     LAYERS)
    port = GaussianLSTMPredictor(IN, OUT, H, LAYERS)
    port.load_state_dict(predictor_from_jax(params))
    xs = np.random.RandomState(4).randn(STEPS, B, IN).astype(np.float32)
    jh = jrnn.gaussian_lstm_hidden_init(B, H, LAYERS)
    ph = port.hidden_init(B, torch.float32, "cpu")
    for t, x in enumerate(xs):
        rng = jax.random.PRNGKey(10 + t)
        (jz, jmu, jlv), jh = jrnn.gaussian_lstm_apply(params, jh,
                                                      jnp.asarray(x), rng)
        eps = np.array(jax.random.normal(rng, jmu.shape, jmu.dtype))
        (pz, pmu, plv), ph = port(ph, torch.from_numpy(x),
                                  torch.from_numpy(eps))
        for got, ref in ((pz, jz), (pmu, jmu), (plv, jlv), (ph[0], jh[0]),
                         (ph[1], jh[1])):
            _close(got, ref)
    assert float(jnp.abs(jz - jmu).max()) > 100 * ATOL   # eps matters


@pytest.mark.parametrize("train", [False, True])
def test_gaussian_encoder(train):
    dim, out = 16, 8
    params = jvgg.gaussian_encoder_init(jax.random.PRNGKey(5), dim, out,
                                        nc=1, image_width=64)
    stats = _random_stats(jvgg.gaussian_encoder_stats_init(dim, 1, 64), 6)
    port = GaussianEncoder(dim, out, nc=1, image_width=64)
    port.load_state_dict(gaussian_encoder_from_jax(params, stats))
    x = np.random.RandomState(7).rand(2, 64, 64, 1).astype(np.float32)
    rng = jax.random.PRNGKey(8)
    (jz, jmu, jlv, jskips), _ = jvgg.gaussian_encoder_apply(
        params, stats, jnp.asarray(x), train, rng)
    eps = torch.from_numpy(np.array(
        jax.random.normal(rng, jmu.shape, jmu.dtype)))
    if not train:           # the eval forward runs on the folded trunk
        port.fold_()
    with torch.no_grad():
        fwd = port.train_forward if train else port
        pz, pmu, plv, pskips = fwd(torch.from_numpy(x), eps)[:4]
    for got, ref in ((pz, jz), (pmu, jmu), (plv, jlv)):
        _close(got, ref)
    assert len(pskips) == len(jskips)
    for got, ref in zip(pskips, jskips):
        _close(got, ref, TRAIN_SKIP_ATOL if train else ATOL)


@pytest.mark.parametrize("cls,channels", [(CNNBlockFrame, 1),
                                          (CNNBlockFrame3, 3)])
@pytest.mark.parametrize("train", [False, True])
def test_cnn_block_frame(cls, channels, train):
    params = jcls.cnn_block_frame_init(jax.random.PRNGKey(9),
                                       in_channels=channels)
    stats = _random_stats(jcls.cnn_block_frame_stats_init(), 10)
    port = cls()
    port.load_state_dict(classifier_from_jax(params, stats))
    x = np.random.RandomState(11).rand(2, 15, 64, 64, channels).astype(
        np.float32)
    jlogits, jstats = jcls.cnn_block_frame_apply(params, stats,
                                                 jnp.asarray(x), train)
    with torch.no_grad():
        logits = port(torch.from_numpy(x), train=train)
    _close(logits, jlogits)
    # train mode folds the batch's statistics into the running ones
    for i in (1, 2, 3):
        bn = getattr(port, f"bn{i}")
        _close(bn.running_mean, jstats[f"bn{i}"]["mean"])
        _close(bn.running_var, jstats[f"bn{i}"]["var"])


def test_cnn_block_frame_dropout_draws_from_its_generator():
    port = CNNBlockFrame()
    x = torch.rand((2, 15, 64, 64, 1), generator=torch.Generator()
                   .manual_seed(0))

    def run(seed):
        with torch.no_grad():
            return port(x, train=True,
                        generator=torch.Generator().manual_seed(seed))
    torch.manual_seed(0)
    a = run(1)
    torch.manual_seed(1)
    assert torch.equal(a, run(1))          # the global RNG plays no part
    assert not torch.equal(a, run(2))
    with torch.no_grad():
        assert torch.equal(port(x), port(x, generator=torch.Generator()))


@pytest.mark.parametrize("cls,in_dim,hidden", [(MLP, 90, 50), (MLP2, 10, 6)])
def test_mlp_classifiers(cls, in_dim, hidden):
    params = jcls.mlp_init(jax.random.PRNGKey(12), in_dim=in_dim,
                           hidden=hidden)
    port = cls()
    port.load_state_dict(classifier_from_jax(params))
    x = np.random.RandomState(13).randn(4, in_dim).astype(np.float32)
    ref = jcls.mlp_apply(params, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), ref)

