"""SSIM / PSNR / MSE in plain PyTorch (counterpart of `dvg_tpu/ops/ssim.py`)
and the plain versions of the metric kernels K1 (cyclic gt,
`dvg_tpu/ops/pallas_ssim.py::_kernel_pre`) and K2 (one-to-one pairs,
`pallas_ssim.py::_kernel`).

skimage ≤0.17 compare_ssim / compare_psnr semantics for float images:
uniform 7×7 window, unbiased local covariances (cov_norm = 49/48),
data_range 2.0, C1 = (0.01·2)², C2 = (0.03·2)², and
PSNR = 10·log10(4 / max(mse, 1e-12)). Multi-channel images are scored per
(image, channel) and averaged over channels, so PSNR is the mean of the
per-channel PSNRs.

`ssim_psnr_cyclic_plain` (K1) and `ssim_psnr_images_plain` (K2) are what
the CPU path runs and what the card's kernels (ops/ssim_cuda.py) are held
against.

The Finn variant (`finn_ssim`, `finn_psnr`, `finn_ssim_psnr_batch`,
`finn_eval_seq`): an 11×11 σ 1.5 Gaussian window as a depthwise
`F.conv2d`, biased covariances, L = 1, PSNR = 10·log10(1 / mse), and a NaN
per-channel SSIM replaced by −1. `eval_seq` and `finn_eval_seq` score
(T, B, H, W, C) sequences into (B, T) channel means.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

DATA_RANGE = 2.0
WIN = 7
C1 = (0.01 * DATA_RANGE) ** 2
C2 = (0.03 * DATA_RANGE) ** 2

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def box(x: torch.Tensor, win: int = WIN) -> torch.Tensor:
    """Uniform-window VALID mean over the last two axes: (..., H, W) →
    (..., H−win+1, W−win+1)."""
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape((-1, 1) + x.shape[-2:]), win, stride=1)
    return y.reshape(lead + y.shape[-2:])


def _ssim_map(ux, uy, vx, vy, vxy) -> torch.Tensor:
    return ((2.0 * ux * uy + C1) * (2.0 * vxy + C2)
            / ((ux * ux + uy * uy + C1) * (vx + vy + C2)))


def _psnr(mse: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(DATA_RANGE ** 2 / torch.clamp(mse, min=1e-12))


def _cov_norm(win: int) -> float:
    n = win * win
    return n / (n - 1.0)


# ---------------------------------------------------------------------------
# per-plane metrics ((..., H, W) planes) and the Finn variant
# ---------------------------------------------------------------------------

def ssim(gt: torch.Tensor, pred: torch.Tensor, win_size: int = WIN,
         data_range: Optional[float] = DATA_RANGE) -> torch.Tensor:
    """skimage compare_ssim of (..., H, W) plane pairs → (...);
    `data_range=None` takes each gt plane's own max − min span."""
    gt, pred = gt.float(), pred.float()
    if data_range is None:
        data_range = torch.clamp(gt.amax(dim=(-2, -1)) - gt.amin(dim=(-2, -1)),
                                 min=1e-6)[..., None, None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    cov = _cov_norm(win_size)
    ux, uy = box(gt, win_size), box(pred, win_size)
    vx = cov * (box(gt * gt, win_size) - ux * ux)
    vy = cov * (box(pred * pred, win_size) - uy * uy)
    vxy = cov * (box(gt * pred, win_size) - ux * uy)
    return ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)
            / ((ux * ux + uy * uy + c1) * (vx + vy + c2))).mean(dim=(-2, -1))


def psnr(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """skimage compare_psnr (data range 2) of (..., H, W) planes → (...)."""
    return _psnr(mse_metric(gt.float(), pred.float()))


def mse_metric(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean squared error of (..., H, W) planes → (...)."""
    return ((gt - pred) ** 2).mean(dim=(-2, -1))


def _gaussian_1d(size: int = 11, sigma: float = 1.5,
                 device=None) -> torch.Tensor:
    """The normalized 1-D taps −(size//2)..size//2 of the Finn window."""
    half = size // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _gaussian_window(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    """fspecial_gauss: the size × size Gaussian window, normalized."""
    half = size // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    g = torch.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / (2.0 * sigma ** 2)))
    return g / g.sum()


def _conv_planes(x: torch.Tensor, *kernels: torch.Tensor) -> torch.Tensor:
    """VALID cross-correlation of every (H, W) plane of x (..., H, W) with
    each 2-D kernel in turn (a depthwise F.conv2d, one plane per batch
    row)."""
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + x.shape[-2:])
    for k in kernels:
        y = F.conv2d(y, k[None, None])
    return y.reshape(lead + y.shape[-2:])


def _finn_map(mu1, mu2, s11, s22, s12) -> torch.Tensor:
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    v1, v2, v12 = s11 - mu1 * mu1, s22 - mu2 * mu2, s12 - mu1 * mu2
    return ((2 * mu1 * mu2 + c1) * (2 * v12 + c2)
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (v1 + v2 + c2)))


def finn_ssim(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """The reference's finn_ssim of (..., H, W) planes → (...): the 11×11
    σ 1.5 Gaussian window, biased covariances, L = 1, the mean over the
    VALID map."""
    g, p = gt.float(), pred.float()
    w = _gaussian_window(device=g.device)
    f = lambda x: _conv_planes(x, w)
    return _finn_map(f(g), f(p), f(g * g), f(p * p), f(g * p)).mean(
        dim=(-2, -1))


def finn_psnr(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """10·log10(1 / mse) of (..., H, W) planes → (...)."""
    mse = mse_metric(gt.float(), pred.float())
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))


def finn_ssim_psnr_batch(gt: torch.Tensor, pred: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-averaged Finn SSIM and PSNR of gt (B, H, W, C) against pred
    (..., B, H, W, C) → ((..., B), (..., B)). The Gaussian window runs as
    two separable 1-D passes; the gt side is filtered once and broadcast
    over pred's leading axes. A NaN per-channel SSIM counts as −1, as the
    reference's finn_eval_seq records it."""
    g = gt.float().movedim(-1, -3)                      # (B, C, H, W)
    p = pred.float().movedim(-1, -3)                    # (..., B, C, H, W)
    g1 = _gaussian_1d(device=g.device)
    f = lambda x: _conv_planes(x, g1[:, None], g1[None, :])
    s_map = _finn_map(f(g), f(p), f(g * g), f(p * p), f(g * p))
    ssim_bc = s_map.mean(dim=(-2, -1))
    ssim_bc = torch.where(torch.isnan(ssim_bc), -1.0, ssim_bc)
    mse_bc = mse_metric(g, p)
    psnr_bc = 10.0 * torch.log10(1.0 / torch.clamp(mse_bc, min=1e-12))
    return ssim_bc.mean(-1), psnr_bc.mean(-1)


# ---------------------------------------------------------------------------
# batched NHWC metrics
# ---------------------------------------------------------------------------

def ssim_gt_precompute(gt: torch.Tensor, win_size: int = WIN
                       ) -> Dict[str, torch.Tensor]:
    """Ground-truth side of the batched metric for (B, H, W, C) frames: the
    windowed mean and second moment, per (image, channel) plane."""
    g = gt.float().permute(0, 3, 1, 2)
    return {"ux": box(g, win_size), "uxx": box(g * g, win_size), "gt": g}


def ssim_psnr_batch_pre(pre: Dict[str, torch.Tensor], pred: torch.Tensor,
                        win_size: int = WIN
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ssim_psnr_batch` with the gt side precomputed
    (`ssim_gt_precompute` of B images) against pred (..., B, H, W, C) →
    ((..., B), (..., B)) channel-averaged; the gt side broadcasts over
    pred's leading axes."""
    g, ux, uxx = pre["gt"], pre["ux"], pre["uxx"]
    p = pred.float().movedim(-1, -3)                    # (..., B, C, H, W)
    cov = _cov_norm(win_size)
    uy = box(p, win_size)
    vx = cov * (uxx - ux * ux)
    vy = cov * (box(p * p, win_size) - uy * uy)
    vxy = cov * (box(g * p, win_size) - ux * uy)
    ssim_b = _ssim_map(ux, uy, vx, vy, vxy).mean(dim=(-3, -2, -1))
    return ssim_b, _psnr(mse_metric(g, p)).mean(dim=-1)


def ssim_psnr_batch(gt: torch.Tensor, pred: torch.Tensor,
                    win_size: int = WIN) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-averaged SSIM and PSNR of (B, H, W, C) pairs → ((B,), (B,))."""
    return ssim_psnr_batch_pre(ssim_gt_precompute(gt, win_size), pred,
                               win_size)


# ---------------------------------------------------------------------------
# K1: the cyclic-gt metric, plain version
# ---------------------------------------------------------------------------

def gt_box_moments(gt: torch.Tensor) -> Triple:
    """Precompute of the cyclic kernel's gt side for gt (B, H, W, C):
    the per-plane mean mg (B·C,), box(gt − mg) and box((gt − mg)²), each
    (B·C, H', W'), all f32 and contiguous with plane index b·C + c.
    The kernel centres gt with this same mg."""
    b, h, w, c = gt.shape
    g = gt.float().permute(0, 3, 1, 2).reshape(b * c, h, w)
    mg = g.mean(dim=(1, 2))
    gc = g - mg[:, None, None]
    return mg.contiguous(), box(gc).contiguous(), box(gc * gc).contiguous()


def _centred_metrics(g: torch.Tensor, p: torch.Tensor, mg: torch.Tensor,
                     gux: torch.Tensor, gxx: torch.Tensor) -> Triple:
    """The kernels' arithmetic on (..., C, H, W) f32 planes, given the gt
    side's mean mg (..., C, 1, 1) and its boxed centred moments gux =
    box(gt − mg), gxx = box((gt − mg)²), each (..., C, H', W'): pred centred
    by its own mean, box(pc), box(pc²), box(gc·pc), the SSIM map from the
    centred moments, and the direct Σ(g − p)² MSE. → (ssim, psnr, mse),
    each (...) averaged over channels."""
    mp = p.mean(dim=(-2, -1), keepdim=True)
    gc, pc = g - mg, p - mp
    buy, byy, bxy = box(pc), box(pc * pc), box(gc * pc)
    cov = _cov_norm(WIN)
    s_map = _ssim_map(gux + mg, buy + mp, cov * (gxx - gux * gux),
                      cov * (byy - buy * buy), cov * (bxy - gux * buy))
    ssim_v = s_map.mean(dim=(-2, -1))
    mse = ((g - p) ** 2).mean(dim=(-2, -1))
    return ssim_v.mean(-1), _psnr(mse).mean(-1), mse.mean(-1)


def ssim_psnr_cyclic_plain(gt: torch.Tensor, pred: torch.Tensor) -> Triple:
    """K1's plain version. Per-image metrics in the diverse layout: gt
    (B, H, W, C), pred (S·B, H, W, C) sample-major, so pred row p scores
    against gt row p % B. Returns (ssim, psnr, mse), each (S·B,) f32 and
    averaged over channels.

    The same arithmetic as the kernel: gt centred by `gt_box_moments`'
    mean, whose precomputed box(gc), box(gc²) serve every sample."""
    b, h, w, c = gt.shape
    n = pred.shape[0]
    if n % b:
        raise ValueError(f"pred rows {n} are not a multiple of gt rows {b}")
    mg, gux, gxx = gt_box_moments(gt)
    hp, wp = h - WIN + 1, w - WIN + 1
    g = gt.float().permute(0, 3, 1, 2)                      # (B, C, H, W)
    p = pred.float().permute(0, 3, 1, 2).reshape(n // b, b, c, h, w)
    out = _centred_metrics(g, p, mg.reshape(b, c, 1, 1),
                           gux.reshape(b, c, hp, wp),
                           gxx.reshape(b, c, hp, wp))
    return tuple(t.reshape(n) for t in out)


# ---------------------------------------------------------------------------
# K2: the one-to-one metric, plain version
# ---------------------------------------------------------------------------

def ssim_psnr_images_plain(gt: torch.Tensor, pred: torch.Tensor) -> Triple:
    """K2's plain version: gt and pred (N, H, W, C), pred image n scored
    against gt image n → (ssim, psnr, mse), each (N,) f32 averaged over
    channels. The same arithmetic as the kernel, which computes each gt
    plane's mean and boxed centred moments in place (each gt plane is
    scored once, so nothing is precomputed)."""
    if gt.shape != pred.shape:
        raise ValueError(f"gt {tuple(gt.shape)} and pred {tuple(pred.shape)} "
                         "differ")
    g = gt.float().permute(0, 3, 1, 2)                      # (N, C, H, W)
    p = pred.float().permute(0, 3, 1, 2)
    mg = g.mean(dim=(-2, -1), keepdim=True)
    gc = g - mg
    return _centred_metrics(g, p, mg, box(gc), box(gc * gc))


# ---------------------------------------------------------------------------
# sequence evals (the reference's eval_seq / finn_eval_seq output contract)
# ---------------------------------------------------------------------------

def _per_frame(metric, gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """gt, pred (T, B, H, W, C) → (B, T): `metric` of every (H, W) plane,
    averaged over channels."""
    g = torch.as_tensor(gt).float().movedim(-1, 2)       # (T, B, C, H, W)
    p = torch.as_tensor(pred).float().movedim(-1, 2)
    return metric(g, p).mean(dim=-1).transpose(0, 1)


def eval_seq(gt, pred) -> Triple:
    """(T, B, H, W, C) sequences → (mse, ssim, psnr), each (B, T)."""
    return (_per_frame(mse_metric, gt, pred), _per_frame(ssim, gt, pred),
            _per_frame(psnr, gt, pred))


def _finn_ssim_nan_neg1(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    v = finn_ssim(g, p)
    return torch.where(torch.isnan(v), -1.0, v)


def finn_eval_seq(gt, pred) -> Triple:
    """The reference's finn_eval_seq: (mse, Finn ssim with a NaN
    per-channel value as −1, Finn psnr), each (B, T)."""
    return (_per_frame(mse_metric, gt, pred),
            _per_frame(_finn_ssim_nan_neg1, gt, pred),
            _per_frame(finn_psnr, gt, pred))
