"""Wrapper of K1, the hand-written cyclic SSIM/PSNR/MSE kernel
(`csrc/ssim_cyclic.cu`, replacing `dvg_tpu/ops/pallas_ssim.py::_kernel_pre`).

`ssim_psnr_batch_cyclic(gt, pred)` takes gt (B, H, W, C) f32 and pred
(S·B, H, W, C) f32 or bf16, sample-major, and returns (ssim, psnr, mse),
each (S·B,) f32 averaged over channels. For CPU tensors it runs the plain
version (`ops.ssim.ssim_psnr_cyclic_plain`); for CUDA tensors it launches
the kernel or raises — a failed build or launch is an error, never a
fallback. `ssim_psnr_batch_cyclic.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from dvg_tpu_torch.ops import _build
from dvg_tpu_torch.ops.ssim import WIN, Triple, gt_box_moments, \
    ssim_psnr_cyclic_plain

KERNEL = "ssim_cyclic"


def _entry():
    fn = _build.load(KERNEL).dvg_ssim_cyclic
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(gt: torch.Tensor, pred: torch.Tensor) -> None:
    if gt.dim() != 4 or pred.dim() != 4:
        raise ValueError(f"expected NHWC gt and pred, got {tuple(gt.shape)} "
                         f"and {tuple(pred.shape)}")
    if gt.shape[1:] != pred.shape[1:]:
        raise ValueError(f"gt {tuple(gt.shape)} and pred {tuple(pred.shape)} "
                         "differ in (H, W, C)")
    if pred.shape[0] % gt.shape[0]:
        raise ValueError(f"pred rows {pred.shape[0]} are not a multiple of "
                         f"gt rows {gt.shape[0]}")
    if min(gt.shape[1], gt.shape[2]) < WIN:
        raise ValueError(f"images {tuple(gt.shape[1:3])} are smaller than "
                         f"the {WIN}×{WIN} window")


def ssim_psnr_batch_cyclic(gt: torch.Tensor, pred: torch.Tensor) -> Triple:
    _check(gt, pred)
    if gt.device.type == "cpu" and pred.device.type == "cpu":
        return ssim_psnr_cyclic_plain(gt, pred)
    if gt.device.type != "cuda" or gt.device != pred.device:
        raise ValueError(f"gt on {gt.device} and pred on {pred.device}: both "
                         "must be on the same CUDA device, or both on the CPU")
    if gt.dtype != torch.float32:
        raise TypeError(f"gt must be float32, got {gt.dtype}")
    if pred.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pred must be float32 or bfloat16, got {pred.dtype}")
    if not (gt.is_contiguous() and pred.is_contiguous()):
        raise ValueError("gt and pred must be contiguous NHWC")
    out = launch(gt, pred, *gt_box_moments(gt))
    ssim_psnr_batch_cyclic.launches += 1
    s, q, m = out.view(3, pred.shape[0], gt.shape[3]).mean(dim=-1)
    return s, q, m


def launch(gt: torch.Tensor, pred: torch.Tensor, mg: torch.Tensor,
           gux: torch.Tensor, gxx: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs and the gt
    precompute of `gt_box_moments` → per-plane (ssim, psnr, mse) rows,
    (3, N·C) f32. Counts nothing: `ssim_psnr_batch_cyclic` is the entry
    point; this is its launch, exposed for timing the kernel alone."""
    b, h, w, c = gt.shape
    n = pred.shape[0]
    out = torch.empty((3, n * c), dtype=torch.float32, device=gt.device)
    stream = torch.cuda.current_stream(gt.device).cuda_stream
    with torch.cuda.device(gt.device):
        err = _entry()(gt.data_ptr(), pred.data_ptr(),
                       int(pred.dtype == torch.bfloat16), mg.data_ptr(),
                       gux.data_ptr(), gxx.data_ptr(), out.data_ptr(),
                       n, b, h, w, c, stream)
    if err:
        raise RuntimeError(f"{KERNEL} kernel launch failed: cudaError {err}")
    return out


ssim_psnr_batch_cyclic.launches = 0
