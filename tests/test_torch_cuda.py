"""The port's hand-written kernels on the card, against their plain
versions. Imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test here needs a CUDA card and nvcc (marker `gpu`) and skips
without one; the CPU parity of the same code is in the other
tests/test_torch_*.py files. Tolerances as chip_smoke.py states them:
K1 against plain SSIM atol 1e-4, PSNR atol 1e-3 dB, MSE rtol 1e-5; the tiny
f32 slice card against CPU SSIM 1e-4, PSNR 1e-3 dB, MSE rtol 1e-4."""

import numpy as np
import pytest
import torch

from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.generate.rollout import make_rollout_fns
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.ops import ssim as plain
from dvg_tpu_torch.ops.ssim_cuda import ssim_psnr_batch_cyclic

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(dev, b, s, c, dtype):
    g = torch.Generator(device=dev).manual_seed(b * 100 + s * 10 + c)
    gt = torch.rand((b, 64, 64, c), generator=g, device=dev)
    pred = 0.6 * gt.repeat(s, 1, 1, 1) + 0.4 * torch.rand(
        (s * b, 64, 64, c), generator=g, device=dev)
    return gt, pred.to(dtype)


def _close(got, ref, mse_rtol):
    s, q, m = (t.cpu() for t in got)
    rs, rq, rm = (t.cpu() for t in ref)
    assert (s - rs).abs().max() <= 1e-4
    assert (q - rq).abs().max() <= 1e-3
    assert ((m - rm).abs() / rm.abs()).max() <= mse_rtol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c", [(50, 4, 3), (5, 3, 1)])
def test_kernel_matches_plain(cuda, dtype, b, s, c):
    gt, pred = _pair(cuda, b, s, c, dtype)
    before = ssim_psnr_batch_cyclic.launches
    got = ssim_psnr_batch_cyclic(gt, pred)
    torch.cuda.synchronize()
    assert ssim_psnr_batch_cyclic.launches == before + 1
    _close(got, plain.ssim_psnr_cyclic_plain(gt, pred), 1e-5)


def test_kernel_identical_images(cuda):
    gt, _ = _pair(cuda, 8, 1, 3, torch.float32)
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


def test_tiny_slice_card_matches_cpu(cuda):
    cfg = DVGConfig(channels=3, batch_size=2, n_past=2, n_eval=17, g_dim=16,
                    rnn_size=64, num_inducing_points=8, nsample=3,
                    use_pallas=True)
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
