"""Wrappers of K1 and K2, the hand-written SSIM/PSNR/MSE kernels
(`csrc/ssim_cyclic.cu`, one kernel template).

`ssim_psnr_batch_cyclic(gt, pred)` — K1, replacing
`dvg_tpu/ops/pallas_ssim.py::_kernel_pre` and its gt precompute — takes gt
(B, H, W, C) f32 and pred (S·B, H, W, C) f32 or bf16, sample-major, and
returns the channel-averaged (ssim, psnr, mse) of each pred image as one
(3, S·B) f32 tensor, which unpacks as `s, q, m = ...`. (The JAX wrappers
return a tuple; the kernel writes the three rows into one tensor, so the
card path needs no torch op besides its output and the rollout stores a
step's rows with one copy.)

`ssim_psnr_batch_images(gt, pred)` — K2, replacing `pallas_ssim.py::_kernel`
(the counterpart of `ssim_psnr_batch_pallas`) — takes gt (N, H, W, C) f32
and pred (N, H, W, C) f32 or bf16 and scores them pair by pair → (3, N).

Both are registered as custom ops, `torch.ops.dvg_tpu_torch.ssim_cyclic`
(K1) and `torch.ops.dvg_tpu_torch.ssim_images` (K2), and the wrappers call
them: an exported program (`serve/export.py`) holds each call as one node,
which a loaded artifact dispatches like any aten op. Each op's CPU
implementation is its plain version (`ops.ssim`); its CUDA implementation
launches its kernel or raises — a failed build or launch is an error,
never a fallback; its fake implementation gives the (3, N) f32 output's
shape to a trace. The kernel takes C in `CHANNELS` and widths up to
`MAX_WIDTH`; `_check` refuses other CUDA inputs before any launch. Each
wrapper's `.launches` counts its kernel's launches, made by the CUDA
implementation, so launches from inside a loaded artifact count too.

This module imports nothing of `models/` or `generate/`: importing it is
all a serving host needs to load an artifact.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from dvg_tpu_torch.ops import _build
from dvg_tpu_torch.ops.ssim import WIN, ssim_psnr_cyclic_plain, \
    ssim_psnr_images_plain

KERNEL = "ssim_cyclic"
CHANNELS = (1, 3)      # the channel counts the template is compiled for
GROUP = 2              # samples a K1 block scores (kK1Group in the source)
MAX_WIDTH = 128        # the widest image every instance takes

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # gt, pred, pred_is_bf16, out, s, b, h, w, c, stream
    "dvg_ssim_cyclic": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    # gt, pred, pred_is_bf16, out, n, h, w, c, stream
    "dvg_ssim_images": [_P, _P, _I, _P, _I, _I, _I, _I, _P],
    # pred_is_bf16, c, images, h, w, &blocks_per_sm, &threads
    "dvg_ssim_occupancy": [_I, _I, _I, _I, _I, _P, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built if needed, with each C entry's argument
    types bound once."""
    lib = _build.load(KERNEL)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(gt: torch.Tensor, pred: torch.Tensor) -> bool:
    """Checks the shapes; True for CPU tensors (the plain path). For CUDA
    tensors also checks what the kernel takes, and raises on the rest."""
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
    if gt.shape[3] not in CHANNELS:
        raise ValueError(f"the kernel takes C in {CHANNELS}, got C = "
                         f"{gt.shape[3]}")
    if gt.shape[2] > MAX_WIDTH:
        raise ValueError(f"images {gt.shape[2]} px wide are wider than the "
                         f"kernel's {MAX_WIDTH}")
    return False


def ssim_psnr_batch_cyclic(gt: torch.Tensor, pred: torch.Tensor
                           ) -> torch.Tensor:
    return torch.ops.dvg_tpu_torch.ssim_cyclic(gt, pred)


def ssim_psnr_batch_images(gt: torch.Tensor, pred: torch.Tensor
                           ) -> torch.Tensor:
    return torch.ops.dvg_tpu_torch.ssim_images(gt, pred)


def _check_images(gt: torch.Tensor, pred: torch.Tensor) -> bool:
    if gt.shape[0] != pred.shape[0]:
        raise ValueError(f"gt {tuple(gt.shape)} and pred {tuple(pred.shape)} "
                         "differ in N: K2 scores them pair by pair")
    return _check(gt, pred)


@torch.library.custom_op("dvg_tpu_torch::ssim_cyclic", mutates_args=(),
                         device_types="cpu")
def _ssim_cyclic(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    _check(gt, pred)
    return torch.stack(ssim_psnr_cyclic_plain(gt, pred))


@_ssim_cyclic.register_kernel("cuda")
def _ssim_cyclic_cuda(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    _check(gt, pred)
    out = launch(gt, pred)
    ssim_psnr_batch_cyclic.launches += 1
    return out


@_ssim_cyclic.register_fake
def _ssim_cyclic_fake(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    _check(gt, pred)
    return pred.new_empty((3, pred.shape[0]), dtype=torch.float32)


@torch.library.custom_op("dvg_tpu_torch::ssim_images", mutates_args=(),
                         device_types="cpu")
def _ssim_images(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    _check_images(gt, pred)
    return torch.stack(ssim_psnr_images_plain(gt, pred))


@_ssim_images.register_kernel("cuda")
def _ssim_images_cuda(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    _check_images(gt, pred)
    out = launch_images(gt, pred)
    ssim_psnr_batch_images.launches += 1
    return out


@_ssim_images.register_fake
def _ssim_images_fake(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    _check_images(gt, pred)
    return pred.new_empty((3, pred.shape[0]), dtype=torch.float32)


def _raise_on(err: int) -> None:
    if err:
        raise RuntimeError(f"{KERNEL} kernel launch failed: cudaError {err}")


def launch(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """One launch of K1 on checked CUDA inputs → (3, S·B) f32 rows (ssim,
    psnr, mse), each block scoring GROUP samples of one gt image.
    Counts nothing: `ssim_psnr_batch_cyclic` is the entry point; this is
    its launch, exposed for timing the kernel alone."""
    b, h, w, c = gt.shape
    n = pred.shape[0]
    out = torch.empty((3, n), dtype=torch.float32, device=gt.device)
    with torch.cuda.device(gt.device):
        _raise_on(_lib().dvg_ssim_cyclic(
            gt.data_ptr(), pred.data_ptr(), int(pred.dtype == torch.bfloat16),
            out.data_ptr(), n // b, b, h, w, c,
            torch.cuda.current_stream().cuda_stream))
    return out


def launch_images(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """One launch of K2 on checked CUDA inputs → (3, N) f32 rows. Counts
    nothing, like `launch`."""
    n, h, w, c = gt.shape
    out = torch.empty((3, n), dtype=torch.float32, device=gt.device)
    with torch.cuda.device(gt.device):
        _raise_on(_lib().dvg_ssim_images(
            gt.data_ptr(), pred.data_ptr(), int(pred.dtype == torch.bfloat16),
            out.data_ptr(), n, h, w, c,
            torch.cuda.current_stream().cuda_stream))
    return out


def occupancy(pred_dtype: torch.dtype, c: int, h: int, w: int,
              images: bool = False) -> Tuple[int, int]:
    """(resident blocks per SM, threads per block) of K1's instance (K2's
    where `images`) for pred_dtype, C = c and h × w images, as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them on the
    current card."""
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    _raise_on(_lib().dvg_ssim_occupancy(
        int(pred_dtype == torch.bfloat16), c, int(images), h, w,
        ctypes.byref(blocks), ctypes.byref(threads)))
    return blocks.value, threads.value


ssim_psnr_batch_cyclic.launches = 0
ssim_psnr_batch_images.launches = 0
