"""Wrappers of K1 and K2, the hand-written SSIM/PSNR/MSE kernels
(`csrc/ssim_cyclic.cu`, two modes of one kernel template).

`ssim_psnr_batch_cyclic(gt, pred)` — K1, replacing
`dvg_tpu/ops/pallas_ssim.py::_kernel_pre` — takes gt (B, H, W, C) f32 and
pred (S·B, H, W, C) f32 or bf16, sample-major, and returns (ssim, psnr,
mse), each (S·B,) f32 averaged over channels.

`ssim_psnr_batch_images(gt, pred)` — K2, replacing `pallas_ssim.py::_kernel`
(the counterpart of `ssim_psnr_batch_pallas`) — takes gt (N, H, W, C) f32
and pred (N, H, W, C) f32 or bf16 and scores them pair by pair → (ssim,
psnr, mse), each (N,).

For CPU tensors each runs its plain version (`ops.ssim`); for CUDA tensors
it launches its kernel or raises — a failed build or launch is an error,
never a fallback. Each wrapper's `.launches` counts its kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from dvg_tpu_torch.ops import _build
from dvg_tpu_torch.ops.ssim import WIN, Triple, gt_box_moments, \
    ssim_psnr_cyclic_plain, ssim_psnr_images_plain

KERNEL = "ssim_cyclic"


def _entry(name: str, n_ints: int, n_ptrs: int):
    """The C entry `name` of the kernel library: (gt, pred, pred_is_bf16,
    n_ptrs more pointers, n_ints ints, stream) → cudaError_t."""
    fn = getattr(_build.load(KERNEL), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i] + [p] * n_ptrs + [i] * n_ints + [p]
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


def _on_cpu(gt: torch.Tensor, pred: torch.Tensor) -> bool:
    """True for CPU tensors (the plain path); checks what the kernels take
    for CUDA tensors and raises on anything else."""
    if gt.device.type == "cpu" and pred.device.type == "cpu":
        return True
    if gt.device.type != "cuda" or gt.device != pred.device:
        raise ValueError(f"gt on {gt.device} and pred on {pred.device}: both "
                         "must be on the same CUDA device, or both on the CPU")
    if gt.dtype != torch.float32:
        raise TypeError(f"gt must be float32, got {gt.dtype}")
    if pred.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pred must be float32 or bfloat16, got {pred.dtype}")
    if not (gt.is_contiguous() and pred.is_contiguous()):
        raise ValueError("gt and pred must be contiguous NHWC")
    return False


def _channel_mean(out: torch.Tensor, n: int, c: int) -> Triple:
    s, q, m = out.view(3, n, c).mean(dim=-1)
    return s, q, m


def ssim_psnr_batch_cyclic(gt: torch.Tensor, pred: torch.Tensor) -> Triple:
    _check(gt, pred)
    if _on_cpu(gt, pred):
        return ssim_psnr_cyclic_plain(gt, pred)
    out = launch(gt, pred, *gt_box_moments(gt))
    ssim_psnr_batch_cyclic.launches += 1
    return _channel_mean(out, pred.shape[0], gt.shape[3])


def ssim_psnr_batch_images(gt: torch.Tensor, pred: torch.Tensor) -> Triple:
    _check(gt, pred)
    if gt.shape[0] != pred.shape[0]:
        raise ValueError(f"gt {tuple(gt.shape)} and pred {tuple(pred.shape)} "
                         "differ in N: K2 scores them pair by pair")
    if _on_cpu(gt, pred):
        return ssim_psnr_images_plain(gt, pred)
    out = launch_images(gt, pred)
    ssim_psnr_batch_images.launches += 1
    return _channel_mean(out, pred.shape[0], gt.shape[3])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int) -> None:
    if err:
        raise RuntimeError(f"{KERNEL} kernel launch failed: cudaError {err}")


def launch(gt: torch.Tensor, pred: torch.Tensor, mg: torch.Tensor,
           gux: torch.Tensor, gxx: torch.Tensor) -> torch.Tensor:
    """One launch of K1 on checked CUDA inputs and the gt precompute of
    `gt_box_moments` → per-plane (ssim, psnr, mse) rows, (3, N·C) f32.
    Counts nothing: `ssim_psnr_batch_cyclic` is the entry point; this is
    its launch, exposed for timing the kernel alone."""
    b, h, w, c = gt.shape
    n = pred.shape[0]
    out = torch.empty((3, n * c), dtype=torch.float32, device=gt.device)
    with torch.cuda.device(gt.device):
        _raise_on(_entry("dvg_ssim_cyclic", 5, 4)(
            gt.data_ptr(), pred.data_ptr(), int(pred.dtype == torch.bfloat16),
            mg.data_ptr(), gux.data_ptr(), gxx.data_ptr(), out.data_ptr(),
            n, b, h, w, c, _stream(gt)))
    return out


def launch_images(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """One launch of K2 on checked CUDA inputs → per-plane (ssim, psnr,
    mse) rows, (3, N·C) f32. Counts nothing, like `launch`."""
    n, h, w, c = gt.shape
    out = torch.empty((3, n * c), dtype=torch.float32, device=gt.device)
    with torch.cuda.device(gt.device):
        _raise_on(_entry("dvg_ssim_images", 4, 1)(
            gt.data_ptr(), pred.data_ptr(), int(pred.dtype == torch.bfloat16),
            out.data_ptr(), n, h, w, c, _stream(gt)))
    return out


ssim_psnr_batch_cyclic.launches = 0
ssim_psnr_batch_images.launches = 0
