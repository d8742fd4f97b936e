"""Port parity for the backbones beyond DCGAN-64: VGG-64, VGG-128 and
DCGAN-128 of `dvg_tpu_torch` against `dvg_tpu` on the CPU, from the same
weights (carried across by `params_from_jax`) and the same numpy inputs.

Per backbone, at g_dim 16 and batch 2 (the widths are the backbone's own),
against one JAX reference run per backbone shared by the module:
  * the port's BN-folded model (its one eval form) against dvg_tpu's eval
    forward on the unfolded weights, and its hoisted decode against
    dvg_tpu's, f32, atol 1e-5;
  * the grouped train-mode decode (4 calls over 2 unique skip frames) and
    its per-call BN statistics, f32, atol 1e-5;
  * an eval checkpoint written by each package read by the other, every
    leaf equal.
Then VGG-64's `diverse_metrics` (K1's plain version on the port's side)
against `dvg_tpu`'s at the tolerances of tests/test_torch_rollout.py, and
VGG-64 through the training CLI and then the eval CLI, where the
checkpoint's backbone wins over --model. The train step of the new
backbones is tests/test_torch_backbones_train.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.generate.rollout import make_rollout_fns as j_make_rollout_fns
from dvg_tpu.models.dvg import DVGModel as JaxModel
from dvg_tpu.train import checkpoint as jckpt
from dvg_tpu.train import step as JS
from dvg_tpu_torch.checkpoint import (load_checkpoint, load_model,
                                      save_checkpoint)
from dvg_tpu_torch.cli import generate as gen_cli
from dvg_tpu_torch.cli import train as train_cli
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import params_from_jax
from dvg_tpu_torch.generate.rollout import fork_schedule, make_rollout_fns
from dvg_tpu_torch.models import layers as L
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.models.registry import get_backbone
from test_torch_layers import perturb
from test_torch_rollout import jax_noise, jax_state
from test_torch_train import to_np

BACKBONES = {"vgg64": dict(model="vgg", image_width=64),
             "vgg128": dict(model="vgg", image_width=128),
             "dcgan128": dict(model="dcgan", image_width=128)}
TINY = dict(channels=3, batch_size=2, n_past=2, n_eval=17, g_dim=16,
            rnn_size=64, num_inducing_points=8, nsample=3)
ATOL = 1e-5
GROUP_IDX = np.array([0, 1, 1, 0])    # grouped decode: call → unique frame


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker of the multi-worker suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def block_stats(tree, module, block):
    """The JAX stats entry ({mean, var}) of the port's BN block `block`
    inside `module`, found by the block's name (`groups.1.0` → tree
    ["groups"][1][0])."""
    name = next(n for n, m in module.named_modules() if m is block)
    for k in name.split("."):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return tree["bn"]


def assert_stats(module, per_call, new_stats, old_stats):
    """The port's per-call (mean, unbiased var) of every BN block of
    `module`, folded once into the old running statistics, against the
    JAX package's per-call new statistics."""
    m = L.BN_MOMENTUM
    blocks = module.bn_blocks()
    assert len(blocks) == len(per_call)
    for block, (mean, var) in zip(blocks, per_call):
        new = block_stats(new_stats, module, block)
        old = block_stats(old_stats, module, block)
        for key, raw in (("mean", mean), ("var", var)):
            np.testing.assert_allclose(
                (1 - m) * np.asarray(old[key]) + m * raw.numpy(),
                np.asarray(new[key]), atol=ATOL)


@pytest.fixture(scope="module", params=list(BACKBONES))
def net(request):
    """One backbone in both packages on the same perturbed weights, and
    the JAX package's outputs of every compared path, in one jit."""
    kw = dict(TINY, **BACKBONES[request.param])
    cfg, jmodel = DVGConfig(**kw), JaxModel(JaxConfig(**kw))
    params, stats = perturb(*jmodel.init(jax.random.PRNGKey(0)), seed=0)
    port = DVGModel(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, stats, cfg))
    folded = port.fold_inference_params()
    w, b = cfg.image_width, cfg.batch_size
    rng = np.random.RandomState(1)
    x = rng.rand(b, w, w, 3).astype(np.float32)
    with torch.no_grad():
        shapes = [tuple(s.shape[1:]) for s in folded.encode(
            torch.from_numpy(x))[1]]
    # the grouped decode's skips: 2 unique frames, leaky-ReLU-like maps
    skips_u = [np.maximum(rng.randn(2, b, *sh), -0.2).astype(np.float32)
               for sh in shapes]
    lat = rng.uniform(-1, 1, (len(GROUP_IDX), b, cfg.g_dim)
                      ).astype(np.float32)

    @jax.jit
    def reference(params, stats, x, lat, skips_u):
        out = {}
        (h, skips), _ = jmodel.encode(params, stats, x, train=False)
        out["h"], out["skips"] = h, skips
        out["fused"], _ = jmodel.decode(params, stats, h, skips, train=False)
        jf = jmodel.fold_inference_params(params, stats)
        (h_f, skips_f), _ = jmodel.encode(jf, stats, x, train=False)
        out["pre"] = jmodel.decode_skip_pre(jf, skips_f)
        out["hoisted"] = jmodel.decode_hoisted(jf, h_f, out["pre"])
        out["grouped"], out["dec_stats"] = \
            jmodel.backbone.decoder_apply_grouped(
                params["decoder"], stats["decoder"], lat, skips_u, GROUP_IDX,
                train=True)
        return out

    ref = jax.tree.map(np.asarray, reference(params, stats, x, lat, skips_u))
    return dict(name=request.param, cfg=cfg, jcfg=JaxConfig(**kw),
                params=params, stats=stats, port=port, folded=folded, x=x,
                lat=lat,
                skips_u=skips_u, ref=ref)


def test_registry_builds_every_backbone():
    """Both models at both widths build through the registry; their
    folded encoder maps a frame to g_dim and gives the JAX registry's
    number of skips."""
    for model in ("dcgan", "vgg"):
        for width in (64, 128):
            cfg = DVGConfig(**dict(TINY, model=model, image_width=width))
            port = DVGModel(cfg, device="cpu")
            backbone = get_backbone(model, width)
            assert isinstance(port.encoder, backbone.encoder.func)
            assert isinstance(port.decoder, backbone.decoder.func)
            with torch.no_grad():
                h, skips = port.fold_inference_params().encode(
                    torch.zeros(1, width, width, 3))
            assert h.shape == (1, cfg.g_dim)
            assert len(skips) == JaxModel(JaxConfig(**dict(
                TINY, model=model, image_width=width))).backbone.num_skips


def test_eval_forward_matches_jax(net):
    """The folded encode and fused decode against dvg_tpu's eval forward on
    the unfolded weights."""
    folded, ref = net["folded"], net["ref"]
    with torch.no_grad():
        h, skips = folded.encode(torch.from_numpy(net["x"]))
        y = folded.decode(h, skips)
    np.testing.assert_allclose(_np(h), ref["h"], atol=ATOL)
    assert len(skips) == len(ref["skips"])
    for s, s_ref in zip(skips, ref["skips"]):
        np.testing.assert_allclose(_np(s), s_ref, atol=ATOL)
    w = net["cfg"].image_width
    assert y.shape == (2, w, w, 3)
    np.testing.assert_allclose(_np(y), ref["fused"], atol=ATOL)
    # the final activation: sigmoid but for DCGAN-64's tanh
    assert _np(y).min() >= 0.0


def test_hoisted_decode_matches_jax(net):
    """The folded encode, the frozen-skip halves and the hoisted decode
    against the JAX package's; on a merged 3-sample latent with the pre
    tiled once, the hoisted decode equals the folded fused decode."""
    folded, ref = net["folded"], net["ref"]
    with torch.no_grad():
        h, skips = folded.encode(torch.from_numpy(net["x"]))
        pre = folded.decode_skip_pre(skips)
        y = folded.decode_hoisted(h, pre)
        assert len(pre) == len(ref["pre"])
        for p, p_ref in zip(pre, ref["pre"]):
            np.testing.assert_allclose(_np(p), p_ref, atol=ATOL)
        np.testing.assert_allclose(_np(y), ref["hoisted"], atol=ATOL)
        h_m = torch.cat([h * (1 + 0.1 * k) for k in range(3)])
        y_m = folded.decode_hoisted(h_m, [p.repeat(3, 1, 1, 1) for p in pre])
        for k in range(3):
            np.testing.assert_allclose(
                _np(y_m[2 * k:2 * k + 2]),
                _np(folded.decode(h * (1 + 0.1 * k), skips)), atol=ATOL)


def test_folded_fused_decode_matches_jax(net):
    """The folded model's fused decode (VGG: the skip halves computed on the
    call and each up half a folded transposed conv) against the JAX
    package's fused decode, and the folded encode without skips gives the
    same h."""
    folded, ref = net["folded"], net["ref"]
    with torch.no_grad():
        x = torch.from_numpy(net["x"])
        h, skips = folded.encode(x)
        h_bare, none = folded.encode(x, skips=False)
        assert none is None and torch.equal(h_bare, h)
        np.testing.assert_allclose(_np(h), ref["h"], atol=ATOL)
        np.testing.assert_allclose(_np(folded.decode(h, skips)),
                                   ref["fused"], atol=ATOL)


def test_grouped_decode_matches_jax(net):
    """The grouped train-mode decode of 4 calls over 2 unique skip frames
    (per-call BN): frames and every block's per-call statistics."""
    port, ref = net["port"], net["ref"]
    frames, dec_stats = port.decoder.grouped(
        torch.from_numpy(net["lat"]),
        [torch.from_numpy(s) for s in net["skips_u"]],
        torch.from_numpy(GROUP_IDX))
    np.testing.assert_allclose(_np(frames), ref["grouped"], atol=ATOL)
    assert_stats(port.decoder, dec_stats, ref["dec_stats"],
                 net["stats"]["decoder"])


def test_checkpoint_round_trips_each_way(net, tmp_path):
    """A file `dvg_tpu` wrote loads in the port with every leaf equal to
    the layout-mapped weights; a file the port wrote loads in `dvg_tpu`
    with every leaf equal to the JAX weights."""
    cfg, params, stats = net["cfg"], net["params"], net["stats"]
    jckpt.save_checkpoint(str(tmp_path / "jax"), net["jcfg"], JS.TrainState(
        params, stats, {}, np.asarray(0, np.int32)))
    cfg2, model = load_model(str(tmp_path / "jax"), device="cpu")
    assert cfg2 == cfg
    want = params_from_jax(params, stats, cfg)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    save_checkpoint(str(tmp_path / "port"), cfg, model)
    jcfg, payload = jckpt.load_checkpoint(str(tmp_path / "port"))
    assert jcfg == net["jcfg"]
    got = _leaves({"params": payload["params"], "stats": payload["stats"]})
    want = _leaves({"params": serialization.to_state_dict(to_np(params)),
                    "stats": serialization.to_state_dict(to_np(stats))})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# generation: VGG-64's diverse_metrics against dvg_tpu's
# ---------------------------------------------------------------------------

def vgg_gain(path, a):
    """Conv weights rescaled from the init law's std 0.02 to std
    1/√fan-in, the decoder head's to 2/√(I) (each 4×4 output pixel of the
    1×1 → 4×4 transposed conv sees one tap per input channel) and the
    decoder groups' to √2/√fan-in, with the upsampled half of each group's
    first conv doubled: the latent reaches the frames through every
    group, past a LeakyReLU and a skip concat at each, and at std 1/√fan
    the GP fork moved the samples' SSIM by 1.2e-4, under the tolerance;
    at these gains by 6.5e-3 to 1.1e-2 (measured)."""
    name = jax.tree_util.keystr(path)
    if not name.endswith("['w']") or a.ndim != 4:
        return a
    fan = int(np.prod(a.shape[:-1]))
    if name.startswith("['decoder']['head']"):
        return 2.0 * a / (0.02 * np.sqrt(fan // 16))
    a = a / (0.02 * np.sqrt(fan))
    if not name.startswith("['decoder']['groups']"):
        return a
    a = np.sqrt(2.0) * a
    if name.endswith("[0]['conv']['w']"):         # a group's first conv
        a = a.at[:, :, :a.shape[2] // 2].multiply(2.0)
    return a


def test_vgg_diverse_metrics_matches_jax():
    """VGG-64, S 3, B 2, n_past 2, n_eval 17 (a fork at step 15), f32:
    the port's diverse_metrics with K1's plain version against dvg_tpu's
    skimage route, on the same weights and GP noise: SSIM atol 5e-4, PSNR
    1e-2 dB, MSE rtol 1e-3; the fork separates the samples by more than
    the tolerances."""
    kw = dict(TINY, model="vgg", image_width=64, use_pallas=True)
    cfg, jcfg = DVGConfig(**kw), JaxConfig(**kw)
    jmodel = JaxModel(jcfg)
    params, stats = jax_state(jmodel, seed=4, gain=vgg_gain)
    port = DVGModel(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, stats, cfg))
    b, n_free = cfg.batch_size, cfg.n_eval - cfg.n_past
    x = np.random.RandomState(5).rand(cfg.n_eval, b, 64, 64, 3).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    noise = jax_noise(key, cfg.nsample, n_free, b, cfg.g_dim)
    ref = j_make_rollout_fns(jmodel, jcfg.replace(use_pallas=False)
                             ).diverse_metrics(params, stats,
                                               jmodel.gp_cache(params),
                                               jnp.asarray(x), key)
    out = make_rollout_fns(port, cfg).diverse_metrics(x, noise=noise,
                                                      device="cpu")
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    for k in ("ssim", "psnr", "mse"):
        assert out[k].shape == ref[k].shape == (cfg.nsample, n_free, b)
        assert np.all(np.isfinite(out[k]))
    np.testing.assert_allclose(out["ssim"], ref["ssim"], atol=5e-4)
    np.testing.assert_allclose(out["psnr"], ref["psnr"], atol=1e-2)
    np.testing.assert_allclose(out["mse"], ref["mse"], rtol=1e-3)
    fork = np.flatnonzero(fork_schedule(cfg.n_past, cfg.n_eval))[0]
    assert np.ptp(out["ssim"][:, :fork], axis=0).max() == 0
    assert np.ptp(out["ssim"][:, fork], axis=0).min() > 5 * 5e-4
    assert np.ptp(out["psnr"][:, fork], axis=0).min() > 5 * 1e-2
    mse = out["mse"][:, fork]
    assert (np.ptp(mse, axis=0) / mse.mean(0)).min() > 5 * 1e-3


def test_vgg_through_both_clis(tmp_path):
    """The training CLI trains VGG-64 (--model vgg, one step) and writes a
    VGG checkpoint; the eval CLI scores it under --model dcgan, since a
    checkpoint's saved backbone wins under restore-then-override, as in
    dvg_tpu."""
    run = tmp_path / "run"
    assert train_cli.main([
        "--dataset", "smmnist", "--data_root", str(tmp_path / "no_mnist"),
        "--output_path", str(run), "--log_dir", str(run / "logs"),
        "--model", "vgg", "--niter", "1", "--epoch_size", "1",
        "--batch_size", "2", "--n_past", "2", "--n_future", "1",
        "--n_eval", "4", "--g_dim", "8", "--rnn_size", "16",
        "--ckpt_every", "1", "--data_threads", "1", "--device", "cpu"]) == 0
    cfg, sd, payload = load_checkpoint(str(run))
    assert cfg.model == "vgg" and int(payload["step"]) == 1
    assert "encoder.groups.3.2.conv.weight" in sd
    assert gen_cli.main([
        "--model_dir", str(run), "--log_dir", str(tmp_path / "gen"),
        "--model", "dcgan", "--dataset", "smmnist", "--data_root", "",
        "--device", "cpu", "--nsample", "2", "--num_batches", "1",
        "--override_n_eval", "4", "--override_batch_size", "2",
        "--gif_rows", "1"]) == 0
    arrs = np.load(tmp_path / "gen" / "eval_batch0.npz")
    assert arrs["ssim"].shape == (2, 2, 2)
    assert np.isfinite(arrs["ssim"]).all()
