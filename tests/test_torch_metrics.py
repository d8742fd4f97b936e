"""The port's Finn metric and sequence evals (`dvg_tpu_torch.ops.ssim`)
against `dvg_tpu.ops.ssim` on the same numpy-seeded frames, atol 1e-5, at
C 1 and C 3, with a NaN pixel: `finn_ssim`, `finn_psnr`, `mse_metric`,
`finn_ssim_psnr_batch` (the gt side broadcast over a leading sample axis
against JAX's tiled gt, and the NaN → −1 per-channel rule), `eval_seq`
and `finn_eval_seq`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvg_tpu.ops import ssim as J
from dvg_tpu_torch.ops import ssim as P

ATOL = 1e-5


def clips(c, nan=False, t=3, b=2, side=32):
    rng = np.random.RandomState(c)
    gt = rng.rand(t, b, side, side, c).astype(np.float32)
    pred = np.clip(gt + 0.2 * rng.randn(*gt.shape), 0, 1).astype(np.float32)
    if nan:
        pred[1, 0, 3, 4, 0] = np.nan
    return gt, pred


def close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("c", [1, 3])
def test_per_image_finn_functions(c):
    gt, pred = clips(c)
    g, p = gt[0, 0, ..., 0], pred[0, 0, ..., 0]
    for name in ("finn_ssim", "finn_psnr", "mse_metric"):
        close(getattr(P, name)(torch.from_numpy(g), torch.from_numpy(p)),
              getattr(J, name)(jnp.asarray(g), jnp.asarray(p)))
    # planes: every (t, b, channel) at once
    gp = torch.from_numpy(gt).movedim(-1, 2)
    pp = torch.from_numpy(pred).movedim(-1, 2)
    got = P.finn_ssim(gp, pp)
    for t in range(gt.shape[0]):
        for ch in range(c):
            close(got[t, 0, ch], J.finn_ssim(jnp.asarray(gt[t, 0, ..., ch]),
                                             jnp.asarray(pred[t, 0, ..., ch])))


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("c", [1, 3])
def test_finn_batch_broadcasts_gt(c, nan):
    gt, pred = clips(c, nan)
    g, p = gt[0], pred.reshape((-1,) + gt.shape[2:])  # S = T samples of B
    s_n = p.shape[0] // g.shape[0]
    got = P.finn_ssim_psnr_batch(torch.from_numpy(g), torch.from_numpy(
        p.reshape((s_n,) + g.shape)))
    want = J.finn_ssim_psnr_batch(jnp.tile(jnp.asarray(g), (s_n, 1, 1, 1)),
                                  jnp.asarray(p))
    for a, b in zip(got, want):
        close(a.reshape(-1), b)
    if nan:     # the NaN channel scores −1, the others stay finite
        assert (got[0] == -1.0).sum() == (c == 1)
        assert torch.isnan(got[1]).sum() == 1


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("fn", ["eval_seq", "finn_eval_seq"])
def test_sequence_evals(fn, c, nan):
    gt, pred = clips(c, nan)
    got = getattr(P, fn)(torch.from_numpy(gt), torch.from_numpy(pred))
    want = getattr(J, fn)(jnp.asarray(gt), jnp.asarray(pred))
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.shape == (gt.shape[1], gt.shape[0])
        close(a, b)
