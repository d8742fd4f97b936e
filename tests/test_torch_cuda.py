"""The port's hand-written kernels on the card, against their plain
versions, and the card's generation and checkpoint paths against the CPU's.
Imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test here needs a CUDA card and nvcc (marker `gpu`) and skips
without one; the CPU parity of the same code is in the other
tests/test_torch_*.py files. Tolerances as chip_smoke.py states them:
K1 and K2 against plain SSIM atol 1e-4, PSNR atol 1e-3 dB, MSE rtol 1e-5;
the tiny f32 slice card against CPU SSIM 1e-4, PSNR 1e-3 dB, MSE rtol 1e-4;
gp_trigger card against CPU equal masks, frames atol 1e-4, values rtol
1e-4; the tiny train step on the card (f64 and f32) against the CPU's f64
step as chip_smoke.py's `phase_train_tiny` holds it; a TrainState written
and read back on the card; a tiny reference-schema `.pth` imported and
run (f32 posterior) on the card against the same file on the CPU and
against the reference's loop over the unpickled modules, frames atol
1e-4."""

import numpy as np
import pytest
import torch

from dvg_tpu_torch.checkpoint import (load_model, load_train_state,
                                      save_checkpoint, save_train_state)
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.generate.rollout import make_rollout_fns
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.ops import ssim as plain
from dvg_tpu_torch.ops import ssim_cuda
from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                         ssim_psnr_batch_images)
from dvg_tpu_torch.train import init_train_state, make_train_step

TINY = dict(channels=3, batch_size=2, n_past=2, n_eval=17, g_dim=16,
            rnn_size=64, num_inducing_points=8, nsample=3, use_pallas=True)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(dev, b, s, c, dtype, h=64, w=64):
    g = torch.Generator(device=dev).manual_seed(b * 100 + s * 10 + c)
    gt = torch.rand((b, h, w, c), generator=g, device=dev)
    pred = 0.6 * gt.repeat(s, 1, 1, 1) + 0.4 * torch.rand(
        (s * b, h, w, c), generator=g, device=dev)
    return gt, pred.to(dtype)


def _close(got, ref, mse_rtol):
    s, q, m = (t.cpu() for t in got)
    rs, rq, rm = (t.cpu() for t in ref)
    assert (s - rs).abs().max() <= 1e-4
    assert (q - rq).abs().max() <= 1e-3
    assert ((m - rm).abs() / rm.abs()).max() <= mse_rtol


# (B, S, H, W, C): the headline step, a short one, C = 1, DCGAN-128, a
# non-square image, the 7×7 minimum (scalar loads in both passes), B = 1,
# S not a multiple of the sample group, and 60×60 (vector loads in pass 1,
# H·W % 8 == 0; scalar rows in pass 2, W % 8 ≠ 0)
K1_CASES = [(50, 100, 64, 64, 3), (50, 4, 64, 64, 3), (5, 3, 64, 64, 1),
            (4, 2, 128, 128, 3), (3, 2, 48, 80, 1), (2, 3, 7, 7, 3),
            (1, 3, 64, 64, 3), (3, 5, 64, 64, 3), (2, 3, 60, 60, 3)]


def _misaligned(t):
    """A contiguous copy of t whose storage starts one element past a
    16-byte boundary, so the kernel takes its scalar loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,w,c", K1_CASES)
def test_kernel_matches_plain(cuda, dtype, b, s, h, w, c):
    gt, pred = _pair(cuda, b, s, c, dtype, h, w)
    before = ssim_psnr_batch_cyclic.launches
    got = ssim_psnr_batch_cyclic(gt, pred)
    torch.cuda.synchronize()
    assert ssim_psnr_batch_cyclic.launches == before + 1
    assert got.shape == (3, s * b)
    _close(got, plain.ssim_psnr_cyclic_plain(gt, pred), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_misaligned_storage_matches_plain(cuda, dtype):
    gt, pred = _pair(cuda, 3, 3, 3, dtype)
    gt, pred = _misaligned(gt), _misaligned(pred)
    assert gt.data_ptr() % 16 and pred.data_ptr() % 16
    got = ssim_psnr_batch_cyclic(gt, pred)
    torch.cuda.synchronize()
    _close(got, plain.ssim_psnr_cyclic_plain(gt, pred), 1e-5)


@pytest.mark.parametrize("side", [64, 128])
def test_kernel_identical_images(cuda, side):
    gt, _ = _pair(cuda, 8, 1, 3, torch.float32, side, side)
    s, q, m = ssim_psnr_batch_cyclic(gt, gt.repeat(2, 1, 1, 1))
    assert (s - 1).abs().max() <= 1e-4
    assert m.max().item() == 0.0 and q.min().item() > 100.0


def test_kernel_refuses_what_it_does_not_take(cuda):
    gt, pred = _pair(cuda, 2, 2, 3, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ssim_psnr_batch_cyclic(gt, pred.transpose(1, 2))
    with pytest.raises(TypeError, match="float32"):
        ssim_psnr_batch_cyclic(gt.half(), pred)
    with pytest.raises(ValueError, match="same CUDA device"):
        ssim_psnr_batch_cyclic(gt, pred.cpu())
    gt2, pred2 = _pair(cuda, 2, 2, 2, torch.float32)
    with pytest.raises(ValueError, match="takes C in"):
        ssim_psnr_batch_cyclic(gt2, pred2)
    wide = ssim_cuda.MAX_WIDTH + 1
    gt3, pred3 = _pair(cuda, 1, 1, 1, torch.float32, 8, wide)
    with pytest.raises(ValueError, match="wider"):
        ssim_psnr_batch_cyclic(gt3, pred3)


def test_kernel_occupancy(cuda):
    """K1's headline instance (bf16, C 3, 64 px) keeps more than 16 warps
    per SM resident, and every instance of K1 and K2 runs at 128 px."""
    blocks, threads = ssim_cuda.occupancy(torch.bfloat16, 3, 64, 64)
    assert blocks * threads // 32 > 16
    for dtype in (torch.float32, torch.bfloat16):
        for c in ssim_cuda.CHANNELS:
            for images in (False, True):
                assert ssim_cuda.occupancy(dtype, c, 128, 128, images)[0] >= 1


def test_tiny_slice_card_matches_cpu(cuda):
    cfg = DVGConfig(**TINY)
    rng = np.random.RandomState(0)
    x = rng.rand(17, 2, 64, 64, 3).astype(np.float32)
    noise = rng.randn(15, 3, 2, 16).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        model = DVGModel(cfg, seed=0, device=dev)
        res = make_rollout_fns(model, cfg).diverse_metrics(x, noise=noise,
                                                           device=dev)
        out[dev] = [res[k] for k in ("ssim", "psnr", "mse")]
    _close(out["cuda"], out["cpu"], 1e-4)


# ---------------------------------------------------------------------------
# K2: one-to-one pairs
# ---------------------------------------------------------------------------

# (N, H, W, C): as K1_CASES, one-to-one
K2_CASES = [(64, 64, 64, 3), (7, 64, 64, 1), (8, 128, 128, 3),
            (6, 48, 80, 1), (5, 7, 7, 3), (1, 64, 64, 3), (4, 60, 60, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c", K2_CASES)
def test_images_kernel_matches_plain(cuda, dtype, n, h, w, c):
    gt, pred = _pair(cuda, n, 1, c, dtype, h, w)
    before = ssim_psnr_batch_images.launches
    got = ssim_psnr_batch_images(gt, pred)
    torch.cuda.synchronize()
    assert ssim_psnr_batch_images.launches == before + 1
    assert all(t.shape == (n,) for t in got)
    _close(got, plain.ssim_psnr_images_plain(gt, pred), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_images_kernel_misaligned_storage_matches_plain(cuda, dtype):
    gt, pred = _pair(cuda, 5, 1, 3, dtype)
    gt, pred = _misaligned(gt), _misaligned(pred)
    got = ssim_psnr_batch_images(gt, pred)
    torch.cuda.synchronize()
    _close(got, plain.ssim_psnr_images_plain(gt, pred), 1e-5)


@pytest.mark.parametrize("side", [64, 128])
def test_images_kernel_identical_images(cuda, side):
    gt, _ = _pair(cuda, 8, 1, 3, torch.float32, side, side)
    same = gt.to(torch.bfloat16)
    s, q, m = ssim_psnr_batch_images(same.float(), same)
    assert (s - 1).abs().max() <= 1e-4
    assert m.max().item() == 0.0 and q.min().item() > 100.0


def test_images_kernel_refuses_what_it_does_not_take(cuda):
    gt, pred = _pair(cuda, 4, 1, 3, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ssim_psnr_batch_images(gt, pred.transpose(1, 2))
    with pytest.raises(TypeError, match="float32"):
        ssim_psnr_batch_images(gt.half(), pred)
    with pytest.raises(ValueError, match="same CUDA device"):
        ssim_psnr_batch_images(gt, pred.cpu())
    with pytest.raises(ValueError, match="pair by pair"):
        ssim_psnr_batch_images(gt, torch.cat([pred, pred]))


# ---------------------------------------------------------------------------
# generation and checkpoints, card against CPU
# ---------------------------------------------------------------------------

def _trained_gp(model, seed):
    """Weights at unit gain per layer, spread inducing points and a
    non-identity variational Cholesky: at the init's std 0.02 and L_S = I
    the GP variance barely moves and no margin splits the decisions."""
    rng = np.random.RandomState(seed)
    d, m = model.gp.var_mean.shape
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.ConvTranspose2d):
                fan = mod.weight.shape[0] * mod.weight[0, 0].numel() // 4
            elif isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                fan = mod.weight[0].numel()
            else:
                continue
            mod.weight.mul_(1.0 / (0.02 * np.sqrt(fan)))
        model.gp.z.copy_(torch.tensor(
            np.linspace(-1, 1, m)[None, :, None]
            + rng.uniform(-0.03, 0.03, (d, m, 1)), dtype=torch.float32))
        model.gp.var_chol.copy_(torch.tensor(
            np.eye(m) * rng.uniform(0.2, 0.6, (d, 1, m))
            + np.tril(rng.normal(0, 0.1, (d, m, m)), -1),
            dtype=torch.float32))
        model.gp.raw_lengthscale.fill_(-1.2)
    return model


def test_gp_trigger_card_matches_cpu(cuda):
    cfg = DVGConfig(**TINY)
    x = np.random.RandomState(1).rand(17, 2, 64, 64, 3).astype(np.float32)
    cpu = _trained_gp(DVGModel(cfg, seed=0, device="cpu"), seed=2)
    card = DVGModel(cfg, seed=0, device="cpu")
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda)
    # among the margins at which some but not all decisions fire, the one
    # whose nearest decision sits farthest from its threshold
    runs = []
    for margin in (0.0, 1e-3, 3e-3, 1e-2, 3e-2, 0.1):
        fr, diag = make_rollout_fns(cpu, cfg.replace(trigger_margin=margin)
                                    ).gp_trigger(x, seed=3, device="cpu")
        gap = (diag["values"] - diag["thresholds"]).abs().min().item()
        if diag["triggers"].any() and not diag["triggers"].all():
            runs.append((gap, margin, fr, diag))
    gap, margin, fr, diag = max(runs, key=lambda r: r[0])
    fr_c, diag_c = make_rollout_fns(card, cfg.replace(trigger_margin=margin)
                                    ).gp_trigger(x, seed=3, device="cuda")
    assert torch.equal(diag_c["triggers"].cpu(), diag["triggers"])
    assert (fr_c.cpu() - fr).abs().max() <= 1e-4
    for k in ("values", "warmup_values"):
        assert ((diag_c[k].cpu() - diag[k]).abs() / diag[k]).max() <= 1e-4
    d = (diag_c["values"] - diag_c["thresholds"]).cpu() \
        - (diag["values"] - diag["thresholds"])
    assert gap >= 10 * d.abs().max().item()


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    cfg = DVGConfig(**TINY)
    model = DVGModel(cfg, seed=4, device="cuda")
    path = save_checkpoint(str(tmp_path), cfg, model)
    cfg2, loaded = load_model(path, device="cuda")
    assert cfg2 == cfg and loaded.device.type == "cuda"
    want, got = model.state_dict(), loaded.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].device.type == "cuda" and torch.equal(got[k], want[k]), k


def test_train_step_card_matches_cpu(cuda):
    """chip_smoke.py's tiny train phase: the card's step in f64 and f32
    against the CPU's f64 step (metrics, each pass's gradients, the folded
    statistics, the post-step encoder and decoder)."""
    import chip_smoke
    chip_smoke.phase_train_tiny()


def test_train_state_round_trip_on_card(cuda, tmp_path):
    cfg = DVGConfig(**dict(TINY, n_future=3, epoch_size=4, seed=4))
    state = init_train_state(cfg, device="cuda")
    step = make_train_step(cfg)
    x = torch.rand((cfg.seq_len_train, 2, 64, 64, 3), device="cuda")
    step(state, x)
    path = save_train_state(str(tmp_path), cfg, state)
    cfg2, loaded = load_train_state(path, device="cuda")
    assert cfg2 == cfg and loaded.step == state.step == 1
    assert loaded.opts.counts == state.opts.counts
    want, got = state.model.state_dict(), loaded.model.state_dict()
    for k in want:
        assert got[k].device.type == "cuda" and torch.equal(got[k], want[k]), k
    for g, opt in state.opts.adam.items():
        for p, q in zip(state.opts.params(g), loaded.opts.params(g)):
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.state[p][key],
                                   loaded.opts.adam[g].state[q][key]), g
    _, metrics = step(loaded, x)
    assert loaded.step == 2
    assert all(torch.isfinite(v).item() for v in metrics.values())


def test_reference_import_card_matches_cpu(cuda, tmp_path):
    """chip_smoke.py's tiny [import] step as a test: a DCGAN-64 `.pth` in
    the reference's schema imported and run on the card equals the same
    file imported and run on the CPU, and the reference's posterior loop
    over its unpickled modules on the card."""
    import chip_smoke
    cfg = DVGConfig(**dict(chip_smoke.IMPORT_TINY, model="dcgan",
                           image_width=64))
    pth = chip_smoke.write_reference_pth(cfg, str(tmp_path / "model.pth"),
                                         seed=2)
    x = np.random.RandomState(1).rand(cfg.n_eval, cfg.batch_size, 64, 64,
                                      3).astype(np.float32)
    card, _, _ = chip_smoke.port_posterior(pth, str(tmp_path / "card"), x,
                                           "cuda")
    cpu, _, _ = chip_smoke.port_posterior(pth, str(tmp_path / "cpu"), x,
                                          "cpu")
    ref = chip_smoke.reference_posterior(pth, x, "cuda")
    assert card.shape == x.shape and bool(torch.isfinite(card).all())
    assert (card - cpu).abs().max() <= 1e-4
    assert (card - ref).abs().max() <= 1e-4
