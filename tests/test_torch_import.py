"""The port's reference-checkpoint importer (`dvg_tpu_torch.train.
import_torch`) against `dvg_tpu.train.import_torch`, on the CPU, for the
four backbones at `__graft_entry__._tiny_cfg`'s geometry (g_dim 16, rnn
64, 8 inducing points; the backbones' conv widths are the reference's).

Each backbone's `.pth` is written in the reference's schema by the port's
writer from reference modules that carry a seeded port model's weights
(unit gain, non-trivial BN statistics, spread inducing points), and
imported once by each package (a module fixture):
  (a) the two model.ckpt files are equal leaf for leaf: config, params,
      stats, opt_states and step, exactly;
  (b) a DCGAN-64 `.pth` written by `dvg_tpu`'s writer (the only backbone
      it can write) imports in the port to the same file; the port-written
      `.pth` of every backbone imports in `dvg_tpu` (in (a));
  (c) the imported DCGAN-64 checkpoint's `posterior` (f32) equals
      `dvg_tpu`'s on the same file within atol 1e-4 (test_torch_generate's
      frame tolerance);
  (d) port model → `j2t_*` → `.pth` → import gives back every weight and
      statistic exactly, and t2j_convT composed with the shared tree's
      map to the port is the identity;
  (e) `python -m dvg_tpu_torch.train.import_torch` in-process, then the
      eval CLI on `--device cpu` from its output.
"""

import argparse
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.generate.rollout import make_rollout_fns as j_make_rollout_fns
from dvg_tpu.models.dvg import DVGModel as JaxModel
from dvg_tpu.train import import_torch as JIT
from dvg_tpu_torch import _msgpack
from dvg_tpu_torch.checkpoint import load_model
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import (_lists, conv_transpose_weight,
                                   conv_weight, params_to_jax)
from dvg_tpu_torch.generate.rollout import make_rollout_fns
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.train import import_torch as IT

FRAME_ATOL = 1e-4
BACKBONES = {"dcgan64": ("dcgan", 64), "dcgan128": ("dcgan", 128),
             "vgg64": ("vgg", 64), "vgg128": ("vgg", 128)}


def tiny_cfg(model: str, width: int) -> DVGConfig:
    return DVGConfig.from_dict(dict(__graft_entry__._tiny_cfg().to_dict(),
                                    model=model, image_width=width))


def port_model(cfg: DVGConfig, seed: int = 0) -> DVGModel:
    """A seeded port model at unit gain (std 1/√fan-in, so the latent
    reaches the frames), with non-trivial BN statistics and a
    well-conditioned GP (spread inducing points, a trained-looking
    variational mean, lengthscale and noise)."""
    model = DVGModel(cfg, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.ConvTranspose2d):
                fan = m.weight.shape[0] * m.weight[0, 0].numel() // 4
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                fan = m.weight[0].numel()
            else:
                continue
            m.weight.mul_(1.0 / (0.02 * math.sqrt(fan)))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(0, 0.1, buf.shape)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape)))
        d, m = model.gp.var_mean.shape
        model.gp.z.copy_(torch.from_numpy(
            np.linspace(-1, 1, m)[None, :, None]
            + rng.uniform(-0.03, 0.03, (d, m, 1))))
        model.gp.var_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, (d, m))))
        model.gp.raw_lengthscale.fill_(-1.2)
        model.likelihood.raw_noise.fill_(-2.0)
    return model


def reference_opt(cfg: DVGConfig) -> argparse.Namespace:
    """The reference's opt namespace: its fields (no num_inducing_points),
    plus one the port's config does not have."""
    fields = {k: v for k, v in cfg.to_dict().items()
              if k != "num_inducing_points"}
    return argparse.Namespace(**fields, posterior_rnn_layers=1)


def write_pth(path: str, model: DVGModel, cfg: DVGConfig, writer=IT) -> str:
    """`model`'s weights as a reference-schema `.pth`, through `writer`'s
    torch classes and `save_reference_style_checkpoint` (the port's, or
    `dvg_tpu`'s for DCGAN-64)."""
    params, stats = params_to_jax(model.state_dict(), cfg)
    if writer is IT:
        enc, dec, fp = IT.reference_modules(params, stats, cfg)
    else:
        c = writer.torch_classes()
        enc = c["DcganEncoder"](cfg.g_dim, cfg.channels, cfg.image_width)
        dec = c["DcganDecoder"](cfg.g_dim, cfg.channels, cfg.image_width)
        fp = c["RefLSTM"](cfg.g_dim, cfg.g_dim, cfg.rnn_size,
                          cfg.predictor_rnn_layers, cfg.batch_size)
        writer.dcgan_encoder_j2t(params["encoder"], stats["encoder"], enc)
        writer.dcgan_decoder_j2t(params["decoder"], stats["decoder"], dec)
        writer.lstm_j2t(params["frame_predictor"], fp)
    gp_sd, lik_sd = IT.gp_state_dicts_j2t(params["gp"], params["likelihood"])
    writer.save_reference_style_checkpoint(path, enc, dec, fp, gp_sd,
                                           lik_sd, reference_opt(cfg))
    return path


def payload(path: str) -> dict:
    with open(path, "rb") as f:
        return _msgpack.unpackb(f.read())


def assert_tree_equal(a, b, path="") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}/{i}")
    elif isinstance(a, (str, bytes, int, float)):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture(scope="module")
def imports(tmp_path_factory):
    """name → one backbone's port model, its port-written `.pth` and that
    file imported by each package, built at first use (one JAX import per
    backbone for the whole module)."""
    done = {}

    def get(name):
        if name not in done:
            cfg = tiny_cfg(*BACKBONES[name])
            tmp = tmp_path_factory.mktemp(name)
            model = port_model(cfg)
            pth = write_pth(str(tmp / "model.pth"), model, cfg)
            port = IT.import_checkpoint(pth, str(tmp / "port"), device="cpu")
            jax_out = JIT.import_checkpoint(pth, str(tmp / "jax"))
            done[name] = dict(name=name, cfg=cfg, model=model, pth=pth,
                              port=port, jax=jax_out, tmp=tmp)
        return done[name]
    return get


@pytest.fixture(params=list(BACKBONES))
def imported(request, imports):
    return imports(request.param)


def test_import_equals_dvg_tpu(imported):
    got, want = payload(imported["port"]), payload(imported["jax"])
    assert set(got) == set(want) == {"config", "opt_states", "params",
                                     "stats", "step"}
    for key in want:
        assert_tree_equal(got[key], want[key], key)
    cfg = DVGConfig.from_dict(json.loads(got["config"]))
    model, width = BACKBONES[imported["name"]]
    assert (cfg.model, cfg.image_width, cfg.num_inducing_points) == (
        model, width, imported["cfg"].num_inducing_points)
    assert int(np.asarray(got["step"])) == 0


def test_cross_writer(imports):
    """A DCGAN-64 `.pth` from `dvg_tpu`'s writer imports in the port to the
    same file as the port-written one, and the port-written one imports in
    `dvg_tpu` with the port model's weights."""
    imported = imports("dcgan64")
    cfg, tmp = imported["cfg"], imported["tmp"]
    got = _lists(payload(imported["jax"])["params"])
    want, _ = params_to_jax(imported["model"].state_dict(), cfg)
    assert_tree_equal(got, want)
    pth = write_pth(str(tmp / "jax_written.pth"), imported["model"], cfg,
                    writer=JIT)
    out = IT.import_checkpoint(pth, str(tmp / "from_jax_writer.ckpt"),
                               device="cpu")
    assert_tree_equal(payload(out), payload(imported["port"]))


def test_round_trip_exact(imported):
    """port model → reference modules → `.pth` → import: every weight and
    BN statistic comes back exactly."""
    cfg, model = load_model(imported["port"], device="cpu")
    want = imported["model"].state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k
    assert cfg.model == imported["cfg"].model


def test_conv_transpose_composition_is_identity():
    """A reference ConvTranspose2d weight (I, O, kh, kw) through t2j_convT
    (flip, then HWIO) and the shared tree's map into the port's
    ConvTranspose2d (flip back, then (I, O, kh, kw)) is itself; the same
    for Conv2d; and j2t_convT inverts t2j_convT."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(6, 5, 4, 3, generator=g)
    assert torch.equal(conv_transpose_weight(IT.t2j_convT(w)), w)
    assert torch.equal(conv_weight(IT.t2j_conv(w)), w)
    back = torch.empty_like(w)
    IT.j2t_convT(back, IT.t2j_convT(w))
    assert torch.equal(back, w)
    ref = torch.nn.ConvTranspose2d(6, 5, (4, 3), 2, 1)
    IT.j2t_convT(ref.weight, IT.t2j_convT(w))
    x = torch.randn(2, 6, 7, 7, generator=g)
    port = torch.nn.ConvTranspose2d(6, 5, (4, 3), 2, 1)
    with torch.no_grad():
        port.weight.copy_(conv_transpose_weight(IT.t2j_convT(w)))
        port.bias.copy_(ref.bias)
    assert torch.equal(port(x), ref(x))


def test_posterior_equals_dvg_tpu(imports):
    imported = imports("dcgan64")
    p = payload(imported["port"])
    jcfg = JaxConfig.from_dict(json.loads(p["config"]))
    params = jax.tree.map(jnp.asarray, _lists(p["params"]))
    stats = jax.tree.map(jnp.asarray, _lists(p["stats"]))
    jmodel = JaxModel(jcfg)
    x = np.random.RandomState(5).rand(jcfg.n_eval, 2, 64, 64,
                                      jcfg.channels).astype(np.float32)
    want = np.asarray(j_make_rollout_fns(jmodel, jcfg, nsample=2).posterior(
        params, stats, jmodel.gp_cache(params), jnp.asarray(x)))
    cfg, model = load_model(imported["port"], device="cpu")
    got = make_rollout_fns(model, cfg).posterior(x, device="cpu").numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_ATOL)
    # the frames depend on the weights: not a constant image
    assert np.ptp(got[cfg.n_past:]) > 0.1


def test_import_cli_then_eval_cli(imports, tmp_path):
    imported = imports("dcgan64")
    from dvg_tpu_torch.cli import generate as gen_cli
    out = str(tmp_path / "run")
    assert IT.main([imported["pth"], out, "--device", "cpu"]) == 0
    assert_tree_equal(payload(os.path.join(out, "model.ckpt")),
                      payload(imported["port"]))
    logs = tmp_path / "gen"
    assert gen_cli.main([
        "--device", "cpu", "--model_dir", out, "--log_dir", str(logs),
        "--dataset", "smmnist", "--data_root", "", "--nsample", "2",
        "--num_batches", "1", "--override_n_eval", "6",
        "--override_batch_size", "2", "--gif_rows", "1"]) == 0
    arrs = np.load(logs / "eval_batch0.npz")
    assert arrs["ssim"].shape == (2, 2, 4) and np.isfinite(arrs["ssim"]).all()
    assert (logs / "sample_lstm_0.gif").exists()
