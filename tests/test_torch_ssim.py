"""Port parity: the plain-PyTorch metrics and the plain versions of K1
(`ssim_psnr_cyclic_plain`) and K2 (`ssim_psnr_images_plain`) — what the CPU
path runs and what the card's kernels are held against — against
`dvg_tpu` on the CPU.

K1's plain version is held to the interpret-mode Pallas kernel
(`ssim_psnr_batch_pallas_cyclic(..., interpret=True)`, as
tests/test_pallas_ssim.py runs it) and to `dvg_tpu.ops.ssim.ssim_psnr_batch`
on tiled gt; K2's to `ssim_psnr_batch_pallas(..., interpret=True)` and to
`ssim_psnr_batch` on the same pairs. Tolerances: SSIM atol 1e-5 (tighter than the 5e-4 the Pallas
tests hold), PSNR atol 1e-3 dB, MSE rtol 1e-5. The kernel itself runs only
on a card: tests/test_torch_cuda.py compares it with the plain version
there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvg_tpu.ops import ssim as jssim
from dvg_tpu.ops.pallas_ssim import (ssim_psnr_batch_pallas,
                                     ssim_psnr_batch_pallas_cyclic)
from dvg_tpu_torch.ops import ssim as tssim
from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                         ssim_psnr_batch_images)

SSIM_ATOL, PSNR_ATOL, MSE_RTOL = 1e-5, 1e-3, 1e-5


def _pair(seed, b, s, c, dtype=np.float32, h=64, w=64):
    """gt (B, H, W, C) and a correlated pred (S·B, H, W, C)."""
    rng = np.random.RandomState(seed)
    gt = rng.rand(b, h, w, c).astype(np.float32)
    pred = (0.6 * np.tile(gt, (s, 1, 1, 1))
            + 0.4 * rng.rand(s * b, h, w, c)).astype(dtype)
    return gt, pred


def _check(got, ref_s, ref_q, ref_m):
    s, q, m = (t.numpy() for t in got)
    np.testing.assert_allclose(s, np.asarray(ref_s), atol=SSIM_ATOL)
    np.testing.assert_allclose(q, np.asarray(ref_q), atol=PSNR_ATOL)
    np.testing.assert_allclose(m, np.asarray(ref_m), rtol=MSE_RTOL)


# (B, S, C, H, W): 64 px, then the kernel's other sizes at tiny batches —
# DCGAN-128 and a non-square one-channel image
@pytest.mark.parametrize("b,s,c,h,w", [(5, 3, 3, 64, 64), (4, 2, 1, 64, 64),
                                       (2, 2, 3, 128, 128),
                                       (2, 2, 1, 48, 80)])
def test_cyclic_plain_matches_pallas_interpret(b, s, c, h, w):
    gt, pred = _pair(0, b, s, c, h=h, w=w)
    ref = ssim_psnr_batch_pallas_cyclic(jnp.asarray(gt), jnp.asarray(pred),
                                        interpret=True)
    _check(tssim.ssim_psnr_cyclic_plain(torch.from_numpy(gt),
                                        torch.from_numpy(pred)), *ref)


def test_cyclic_plain_bf16_pred_matches_pallas_interpret():
    """The rollout hands pred over in bf16; both sides widen the same bf16
    values to f32."""
    gt, pred = _pair(1, 5, 2, 3)
    pred_t = torch.from_numpy(pred).to(torch.bfloat16)
    pred_j = jnp.asarray(pred_t.float().numpy()).astype(jnp.bfloat16)
    ref = ssim_psnr_batch_pallas_cyclic(jnp.asarray(gt), pred_j,
                                        interpret=True)
    _check(tssim.ssim_psnr_cyclic_plain(torch.from_numpy(gt), pred_t), *ref)


@pytest.mark.parametrize("c", [1, 3])
def test_cyclic_plain_matches_xla_on_tiled_gt(c):
    b, s = 4, 3
    gt, pred = _pair(2, b, s, c)
    gt_tiled = np.tile(gt, (s, 1, 1, 1))
    ref_s, ref_q = jssim.ssim_psnr_batch(jnp.asarray(gt_tiled),
                                         jnp.asarray(pred))
    ref_m = np.mean((gt_tiled - pred) ** 2, axis=(1, 2, 3))
    _check(tssim.ssim_psnr_cyclic_plain(torch.from_numpy(gt),
                                        torch.from_numpy(pred)),
           ref_s, ref_q, ref_m)


@pytest.mark.parametrize("c", [1, 3])
def test_batch_metric_matches_xla(c):
    gt, pred = _pair(3, 6, 1, c)
    ref_s, ref_q = jssim.ssim_psnr_batch(jnp.asarray(gt), jnp.asarray(pred))
    s, q = tssim.ssim_psnr_batch(torch.from_numpy(gt), torch.from_numpy(pred))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), atol=SSIM_ATOL)
    np.testing.assert_allclose(q.numpy(), np.asarray(ref_q), atol=PSNR_ATOL)


@pytest.mark.parametrize("data_range", [2.0, None])
def test_per_image_ssim_psnr_match_jax(data_range):
    gt, pred = _pair(4, 1, 1, 1)
    g, p = gt[0, ..., 0], pred[0, ..., 0]
    ref = jssim.ssim(jnp.asarray(g), jnp.asarray(p), data_range=data_range)
    got = tssim.ssim(torch.from_numpy(g), torch.from_numpy(p),
                     data_range=data_range)
    np.testing.assert_allclose(float(got), float(ref), atol=SSIM_ATOL)
    np.testing.assert_allclose(
        float(tssim.psnr(torch.from_numpy(g), torch.from_numpy(p))),
        float(jssim.psnr(jnp.asarray(g), jnp.asarray(p))), atol=PSNR_ATOL)


def test_identical_images():
    gt, _ = _pair(5, 4, 1, 3)
    pred = np.tile(gt, (2, 1, 1, 1))
    s, q, m = tssim.ssim_psnr_cyclic_plain(torch.from_numpy(gt),
                                           torch.from_numpy(pred))
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-5)
    assert np.all(q.numpy() > 100.0)
    np.testing.assert_allclose(m.numpy(), 0.0, atol=1e-12)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    gt, pred = _pair(6, 2, 2, 3)
    before = ssim_psnr_batch_cyclic.launches
    got = ssim_psnr_batch_cyclic(torch.from_numpy(gt), torch.from_numpy(pred))
    ref = tssim.ssim_psnr_cyclic_plain(torch.from_numpy(gt),
                                       torch.from_numpy(pred))
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    assert ssim_psnr_batch_cyclic.launches == before


def test_wrapper_rejects_bad_shapes():
    gt, pred = _pair(7, 2, 2, 3)
    with pytest.raises(ValueError, match="multiple"):
        ssim_psnr_batch_cyclic(torch.from_numpy(gt),
                               torch.from_numpy(pred[:3]))
    with pytest.raises(ValueError, match=r"\(H, W, C\)"):
        ssim_psnr_batch_cyclic(torch.from_numpy(gt),
                               torch.from_numpy(pred[..., :1].copy()))


# ---------------------------------------------------------------------------
# K2: one-to-one pairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,h,w", [(5, 3, 64, 64), (9, 1, 64, 64),
                                     (2, 3, 128, 128), (2, 1, 48, 80)])
def test_images_plain_matches_pallas_interpret(n, c, h, w):
    """N not a multiple of the Pallas block of 8: its wrapper pads with
    all-ones images, the port has no padding."""
    gt, pred = _pair(8, n, 1, c, h=h, w=w)
    ref = ssim_psnr_batch_pallas(jnp.asarray(gt), jnp.asarray(pred),
                                 interpret=True)
    _check(tssim.ssim_psnr_images_plain(torch.from_numpy(gt),
                                        torch.from_numpy(pred)), *ref)


@pytest.mark.parametrize("c", [1, 3])
def test_images_plain_matches_xla(c):
    gt, pred = _pair(9, 6, 1, c)
    ref_s, ref_q = jssim.ssim_psnr_batch(jnp.asarray(gt), jnp.asarray(pred))
    ref_m = np.mean((gt - pred) ** 2, axis=(1, 2, 3))
    _check(tssim.ssim_psnr_images_plain(torch.from_numpy(gt),
                                        torch.from_numpy(pred)),
           ref_s, ref_q, ref_m)


def test_images_plain_bf16_pred_matches_pallas_interpret():
    gt, pred = _pair(10, 4, 1, 3)
    pred_t = torch.from_numpy(pred).to(torch.bfloat16)
    pred_j = jnp.asarray(pred_t.float().numpy()).astype(jnp.bfloat16)
    ref = ssim_psnr_batch_pallas(jnp.asarray(gt), pred_j, interpret=True)
    _check(tssim.ssim_psnr_images_plain(torch.from_numpy(gt), pred_t), *ref)


def test_images_wrapper_on_cpu_runs_plain_and_counts_nothing():
    gt, pred = _pair(11, 3, 1, 3)
    g, p = torch.from_numpy(gt), torch.from_numpy(pred)
    before = ssim_psnr_batch_images.launches
    for a, r in zip(ssim_psnr_batch_images(g, p),
                    tssim.ssim_psnr_images_plain(g, p)):
        assert torch.equal(a, r)
    assert ssim_psnr_batch_images.launches == before
    s, q, m = ssim_psnr_batch_images(g, g.clone())
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-5)
    assert np.all(q.numpy() > 100.0) and np.all(m.numpy() == 0.0)
    with pytest.raises(ValueError, match="pair by pair"):
        ssim_psnr_batch_images(g, torch.cat([p, p]))
