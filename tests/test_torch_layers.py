"""Port parity: layers and DCGAN-64 of `dvg_tpu_torch` against `dvg_tpu` on
the CPU, f32, on the same weights (carried across by `params_from_jax`)
and the same numpy inputs. Tolerance: atol 1e-5 throughout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.models import layers as JL
from dvg_tpu.models.dvg import DVGModel as JaxModel
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import (conv_transpose_weight, conv_weight,
                                   params_from_jax)
from dvg_tpu_torch.models import layers as L
from dvg_tpu_torch.models.dvg import DVGModel

ATOL = 1e-5
TINY = dict(channels=3, image_width=64, batch_size=2, n_past=2, n_eval=17,
            g_dim=16, rnn_size=64, num_inducing_points=8, nsample=3)


def _np(t):
    return t.detach().cpu().numpy()


def perturb(params, stats, seed):
    """Non-trivial BN statistics, BN affines and biases, so folding and
    bias handling are exercised (the init leaves them at 0/1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if name.endswith("['var']"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if name.endswith("['mean']") or name.endswith("['b']") \
                or name.endswith("['bias']") or name.endswith("['scale']"):
            return jnp.asarray(a + rng.normal(0, 0.1, a.shape), jnp.float32)
        return jnp.asarray(a)

    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map_with_path(leaf, stats))


@pytest.fixture(scope="module")
def models():
    cfg = DVGConfig(**TINY)
    jmodel = JaxModel(JaxConfig(**TINY))
    params, stats = perturb(*jmodel.init(jax.random.PRNGKey(0)), seed=0)
    port = DVGModel(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, stats, cfg))
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    return jmodel, params, stats, port, x


@pytest.mark.parametrize("stride,padding,cin,hw", [(2, 1, 3, 16),
                                                   (1, 0, 32, 4)])
def test_conv2d(stride, padding, cin, hw):
    rng = np.random.RandomState(2)
    w = rng.randn(4, 4, cin, 8).astype(np.float32) * 0.1
    b = rng.randn(8).astype(np.float32) * 0.1
    x = rng.randn(2, hw, hw, cin).astype(np.float32)
    ref = JL.conv2d_apply({"w": w, "b": b}, jnp.asarray(x), stride, padding)
    conv = torch.nn.Conv2d(cin, 8, 4, stride, padding)
    with torch.no_grad():
        conv.weight.copy_(conv_weight(w))
        conv.bias.copy_(torch.from_numpy(b))
        y = L.nhwc(conv(L.nchw(torch.from_numpy(x))))
    np.testing.assert_allclose(_np(y), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("stride,padding,hw", [(2, 1, 8), (1, 0, 1)])
def test_conv_transpose2d(stride, padding, hw):
    rng = np.random.RandomState(3)
    w = rng.randn(4, 4, 6, 5).astype(np.float32) * 0.1
    b = rng.randn(5).astype(np.float32) * 0.1
    x = rng.randn(2, hw, hw, 6).astype(np.float32)
    ref = JL.conv_transpose2d_apply({"w": w, "b": b}, jnp.asarray(x), stride,
                                    padding)
    conv = torch.nn.ConvTranspose2d(6, 5, 4, stride, padding)
    with torch.no_grad():
        conv.weight.copy_(conv_transpose_weight(w))
        conv.bias.copy_(torch.from_numpy(b))
        y = L.nhwc(conv(L.nchw(torch.from_numpy(x))))
    np.testing.assert_allclose(_np(y), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kind", ["conv", "conv_transpose"])
def test_fold_conv_bn(models, kind):
    """Folding scales the OUTPUT channels: dim 0 of a Conv2d weight, dim 1
    of a ConvTranspose2d weight. Folded weights, bias and outputs agree
    with the JAX fold, and folded == conv→BN."""
    jmodel, params, stats, port, x = models
    if kind == "conv":
        jp, js = params["encoder"]["stages"][1], stats["encoder"]["stages"][1]
        block, to_torch = port.encoder.stages[1], conv_weight
        xin = np.random.RandomState(4).randn(2, 32, 32, 64).astype(np.float32)
        j_apply = lambda p, s, v: JL.conv_block_apply(  # noqa: E731
            p, s, v, False, stride=2, padding=1, act=lambda a: a)[0]
    else:
        jp, js = params["decoder"]["stages"][0], stats["decoder"]["stages"][0]
        block, to_torch = port.decoder.stages[0], conv_transpose_weight
        xin = np.random.RandomState(4).randn(2, 4, 4, 1024).astype(np.float32)
        j_apply = lambda p, s, v: JL.upconv_block_apply(  # noqa: E731
            p, s, v, False, stride=2, torch_padding=1, act=lambda a: a)[0]
    jf = JL.fold_conv_bn(jp, js)
    folded = L.fold_conv_bn(block)
    assert folded.bn is None
    np.testing.assert_allclose(_np(folded.conv.weight),
                               _np(to_torch(jf["conv"]["w"])), atol=ATOL)
    np.testing.assert_allclose(_np(folded.conv.bias),
                               np.asarray(jf["conv"]["b"]), atol=ATOL)
    xt = L.nchw(torch.from_numpy(xin))
    ref = np.asarray(j_apply(jf, js, jnp.asarray(xin)))
    np.testing.assert_allclose(_np(L.nhwc(folded(xt))), ref, atol=ATOL)
    np.testing.assert_allclose(_np(L.nhwc(block(xt))), ref, atol=ATOL)


def test_encoder(models):
    jmodel, params, stats, port, x = models
    (h_ref, skips_ref), _ = jmodel.encode(params, stats, jnp.asarray(x),
                                          train=False)
    h, skips = port.encode(torch.from_numpy(x))
    np.testing.assert_allclose(_np(h), np.asarray(h_ref), atol=ATOL)
    assert len(skips) == len(skips_ref) == 4
    for s, s_ref in zip(skips, skips_ref):
        np.testing.assert_allclose(_np(s), np.asarray(s_ref), atol=ATOL)


def test_decoder_fused(models):
    jmodel, params, stats, port, x = models
    (h, skips), _ = jmodel.encode(params, stats, jnp.asarray(x), train=False)
    y_ref, _ = jmodel.decode(params, stats, h, skips, train=False)
    y = port.decode(torch.from_numpy(np.array(h)),
                    [torch.from_numpy(np.array(s)) for s in skips])
    assert y.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), atol=ATOL)


def test_decoder_skip_pre_and_hoisted(models):
    jmodel, params, stats, port, x = models
    jf = jmodel.fold_inference_params(params, stats)
    (h, skips), _ = jmodel.encode(jf, stats, jnp.asarray(x), train=False)
    pre_ref = jmodel.decode_skip_pre(jf, skips)
    y_ref = jmodel.decode_hoisted(jf, h, pre_ref)
    folded = port.fold_inference_params()
    h_t, skips_t = folded.encode(torch.from_numpy(x))
    np.testing.assert_allclose(_np(h_t), np.asarray(h), atol=ATOL)
    pre = folded.decode_skip_pre(skips_t)
    assert len(pre) == len(pre_ref) == 4
    for p, p_ref in zip(pre, pre_ref):
        np.testing.assert_allclose(_np(p), np.asarray(p_ref), atol=ATOL)
    y = folded.decode_hoisted(h_t, pre)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), atol=ATOL)


def test_hoisted_matches_fused(models):
    """decode_hoisted(decode_skip_pre(...)) on folded weights reproduces the
    fused eval decode, also on a merged sample·batch latent with the pre
    tiled once; unfolded weights and an untiled pre are refused."""
    jmodel, params, stats, port, x = models
    h, skips = port.encode(torch.from_numpy(x))
    y_ref = port.decode(h, skips)
    folded = port.fold_inference_params()
    with pytest.raises(ValueError, match="BN-folded"):
        port.decode_hoisted(h, port.decode_skip_pre(skips))
    pre = folded.decode_skip_pre(skips)
    np.testing.assert_allclose(_np(folded.decode_hoisted(h, pre)),
                               _np(y_ref), atol=ATOL)
    s_n = 3
    h_m = torch.cat([h * (1 + 0.1 * k) for k in range(s_n)])
    with pytest.raises(ValueError, match="tile the pre"):
        folded.decode_hoisted(h_m, pre)
    y_m = folded.decode_hoisted(h_m, [p.repeat(s_n, 1, 1, 1) for p in pre])
    for k in range(s_n):
        ref_k = port.decode(h * (1 + 0.1 * k), skips)
        np.testing.assert_allclose(_np(y_m[k * 2:(k + 1) * 2]), _np(ref_k),
                                   atol=ATOL)


def test_unported_backbones_raise():
    """Every backbone the JAX registry has is ported; a model or width
    that neither package has raises the JAX registry's ValueError, with
    the same message, from the port's registry."""
    for kw in (dict(model="resnet"), dict(image_width=32),
               dict(image_width=256)):
        with pytest.raises(ValueError) as want:
            JaxModel(JaxConfig(**dict(TINY, **kw)))
        with pytest.raises(ValueError) as got:
            DVGModel(DVGConfig(**dict(TINY, **kw)), device="cpu")
        assert str(got.value) == str(want.value), kw


def test_config_round_trips_between_packages():
    """The port's own DVGConfig copy has the JAX package's fields, and a
    config written by either package reads in the other."""
    import dataclasses
    assert ([f.name for f in dataclasses.fields(DVGConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    jcfg = JaxConfig(**dict(TINY, dtype="bfloat16", mesh_shape=(("data", 2),)))
    assert DVGConfig.from_dict(jcfg.to_dict()).to_dict() == jcfg.to_dict()
    pcfg = DVGConfig(**dict(TINY, gp_lr_milestones=(4, 6)))
    assert JaxConfig.from_dict(pcfg.to_dict()).to_dict() == pcfg.to_dict()
