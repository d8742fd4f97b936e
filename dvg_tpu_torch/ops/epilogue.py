"""K3, the epilogue of a BN-folded eval conv: out = act(y + pre + bias) in
one pass (`csrc/conv_epilogue.cu`).

`conv_epilogue(y, bias, pre=None, act="none")` takes a conv's output y
(N, C, H, W), computed with no bias, its per-channel bias (C,), an optional
skip half `pre` of y's shape and strides (the hoisted decode's precomputed
half of a split conv), and an activation in `ACTS`. It sums in f32 (f64
stays f64), applies the activation and rounds once to y's dtype. On the TPU
XLA fused these ops into the conv; eagerly each was its own pass over the
conv's output.

It is the custom op `torch.ops.dvg_tpu_torch.conv_epilogue`, out of place:
its CPU implementation is the plain version (`conv_epilogue_plain`), its
CUDA implementation launches the kernel or raises (a failed build or
launch is an error, never a fallback), its fake implementation gives a
trace y's shape, and its autograd formula is the plain backward, so a
graph through it differentiates (no cell runs it with grad). The kernel
takes bf16 and f32, with the bias in y's dtype, and two layouts, read from
y's strides: channels_last memory, where the channel of flat element i is
i % C, and contiguous NCHW, where it is (i / (H·W)) % C; `_check` raises
on any other layout and on a `pre` whose strides differ from y's, on the
CPU too. `conv_epilogue.launches` counts the kernel's launches, in both
forms.

`conv_epilogue_pool(y, bias, act)` is K3's pooled form, for a conv whose
full output nothing else reads (a VGG encoder group's last conv when the
caller wants no skips): the same sum, activation and single rounding of
each element, then the 2×2 stride-2 max-pool (VALID, torch's order of the
window and its NaN rule), writing only the pooled (N, C, H/2, W/2) map. It
is bitwise `max_pool2d(conv_epilogue_plain(y, bias, None, act), 2, 2)`.
It is the custom op `torch.ops.dvg_tpu_torch.conv_epilogue_pool`, out of
place, with a plain CPU version (`conv_epilogue_pool_plain`), a CUDA
implementation that launches the kernel or raises, and a fake; it has no
autograd formula (no path differentiates it). It takes channels_last y
only, and returns channels_last; `conv_epilogue_pool.launches` counts its
launches, which `conv_epilogue.launches` counts too.

Like ops/ssim_cuda.py, this module imports nothing of `models/`: importing
it registers the op for a serving host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dvg_tpu_torch.ops import _build

KERNEL = "conv_epilogue"
NEGATIVE_SLOPE = 0.2
# activation name -> the kernel's code
ACTS = {"none": 0, "leaky_relu": 1, "tanh": 2, "sigmoid": 3}
VECTOR_BYTES = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
# y, pre, bias, out, n, c, inner, is_bf16, act, vec, stream
_SIGNATURE = [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _P]
# y, bias, out, n, c, h, w, is_bf16, act, vec, stream
_POOL_SIGNATURE = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    for fn, sig in ((lib.dvg_conv_epilogue, _SIGNATURE),
                    (lib.dvg_conv_epilogue_pool, _POOL_SIGNATURE)):
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return lib


def activate(z: torch.Tensor, act: str) -> torch.Tensor:
    """`act` (a key of ACTS) on z, in z's dtype."""
    if act == "leaky_relu":
        return torch.nn.functional.leaky_relu(z, NEGATIVE_SLOPE)
    if act == "tanh":
        return torch.tanh(z)
    if act == "sigmoid":
        return torch.sigmoid(z)
    return z


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        pre: Optional[torch.Tensor] = None,
                        act: str = "none") -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: (y + pre) + bias in at least
    f32, the activation, one rounding to y's dtype."""
    at = torch.promote_types(y.dtype, torch.float32)
    z = y.to(at)
    if pre is not None:
        z = z + pre.to(at)
    return activate(z + bias.to(at)[:, None, None], act).to(y.dtype)


def conv_epilogue_pool_plain(y: torch.Tensor, bias: torch.Tensor,
                             act: str = "none") -> torch.Tensor:
    """The pooled kernel's arithmetic in PyTorch: `conv_epilogue_plain`'s
    rounded values, then the max of each 2×2 window taken as the kernel
    takes it: the taps in row-major order, a later one kept if greater or
    NaN. Returns channels_last."""
    z = conv_epilogue_plain(y, bias, None, act)
    ho, wo = y.shape[2] // 2, y.shape[3] // 2
    taps = [z[:, :, i:2 * ho:2, j:2 * wo:2] for i in (0, 1) for j in (0, 1)]
    m = taps[0]
    for t in taps[1:]:
        m = torch.where((t > m) | t.isnan(), t, m)
    return m.contiguous(memory_format=torch.channels_last)


def _dense_strides(t: torch.Tensor) -> tuple:
    """t's strides on its dims longer than 1 (the others address nothing)."""
    return tuple(s for s, n in zip(t.stride(), t.shape) if n > 1)


def _check_shapes(y: torch.Tensor, bias: torch.Tensor,
                  pre: Optional[torch.Tensor], act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}, got {act!r}")
    if y.dim() != 4:
        raise ValueError(f"expected an NCHW-shaped conv output, got "
                         f"{tuple(y.shape)}")
    if tuple(bias.shape) != (y.shape[1],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match y's "
                         f"{y.shape[1]} channels")
    if pre is not None and (pre.shape != y.shape or pre.dtype != y.dtype):
        raise ValueError(f"pre {tuple(pre.shape)} {pre.dtype} differs from "
                         f"y {tuple(y.shape)} {y.dtype}")


def _inner(y: torch.Tensor, pre: Optional[torch.Tensor]) -> int:
    """1 for channels_last memory, H·W for contiguous NCHW (the kernel's
    `inner`); raises on any other layout or on pre's strides differing."""
    if y.is_contiguous(memory_format=torch.channels_last):
        inner = 1
    elif y.is_contiguous():
        inner = y.shape[2] * y.shape[3]
    else:
        raise ValueError(f"y's strides {y.stride()} are neither channels_last "
                         "nor contiguous NCHW")
    if pre is not None and _dense_strides(pre) != _dense_strides(y):
        raise ValueError(f"pre's strides {pre.stride()} differ from y's "
                         f"{y.stride()}")
    return inner


def _check(y: torch.Tensor, bias: torch.Tensor,
           pre: Optional[torch.Tensor], act: str) -> int:
    _check_shapes(y, bias, pre, act)
    return _inner(y, pre)


def _check_pool(y: torch.Tensor, bias: torch.Tensor, act: str) -> None:
    _check_shapes(y, bias, None, act)
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"the pooled epilogue takes channels_last y, got "
                         f"strides {y.stride()}")


def _pooled_like(y: torch.Tensor) -> torch.Tensor:
    n, c, h, w = y.shape
    return torch.empty((n, c, h // 2, w // 2), dtype=y.dtype, device=y.device,
                       memory_format=torch.channels_last)


def _check_cuda(y: torch.Tensor, bias: torch.Tensor,
                pre: Optional[torch.Tensor]) -> None:
    devices = {t.device for t in (y, bias, pre) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"y, bias and pre on {sorted(map(str, devices))}: "
                         "all must be on one CUDA device")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{y.dtype}")
    if bias.dtype != y.dtype or not bias.is_contiguous():
        raise TypeError(f"bias must be a contiguous {y.dtype} vector, got "
                        f"{bias.dtype} with strides {bias.stride()}")


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  pre: Optional[torch.Tensor] = None,
                  act: str = "none") -> torch.Tensor:
    return torch.ops.dvg_tpu_torch.conv_epilogue(y, bias, pre, act)


@torch.library.custom_op("dvg_tpu_torch::conv_epilogue", mutates_args=(),
                         device_types="cpu")
def _conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                   pre: Optional[torch.Tensor], act: str) -> torch.Tensor:
    _check(y, bias, pre, act)
    return conv_epilogue_plain(y, bias, pre, act)


@_conv_epilogue.register_kernel("cuda")
def _conv_epilogue_cuda(y: torch.Tensor, bias: torch.Tensor,
                        pre: Optional[torch.Tensor], act: str
                        ) -> torch.Tensor:
    inner = _check(y, bias, pre, act)
    _check_cuda(y, bias, pre)
    out = launch(y, bias, pre, act, inner)
    conv_epilogue.launches += 1
    return out


@_conv_epilogue.register_fake
def _conv_epilogue_fake(y: torch.Tensor, bias: torch.Tensor,
                        pre: Optional[torch.Tensor], act: str
                        ) -> torch.Tensor:
    _check_shapes(y, bias, pre, act)
    return torch.empty_like(y)


def _setup_context(ctx, inputs, output) -> None:
    _, bias, pre, act = inputs
    ctx.act, ctx.has_pre, ctx.bias_dtype = act, pre is not None, bias.dtype
    ctx.save_for_backward(output)


def _backward(ctx, grad: torch.Tensor):
    """The plain backward: dz = grad · act'(z), with act' read from the
    output (LeakyReLU's sign, tanh's 1 − out², sigmoid's out·(1 − out));
    y and pre get dz, the bias dz summed over (N, H, W)."""
    (out,) = ctx.saved_tensors
    at = torch.promote_types(grad.dtype, torch.float32)
    o, dz = out.to(at), grad.to(at)
    if ctx.act == "leaky_relu":
        dz = torch.where(o > 0, dz, dz * NEGATIVE_SLOPE)
    elif ctx.act == "tanh":
        dz = dz * (1.0 - o * o)
    elif ctx.act == "sigmoid":
        dz = dz * o * (1.0 - o)
    dy = dz.to(grad.dtype)
    return (dy, dz.sum((0, 2, 3)).to(ctx.bias_dtype),
            dy if ctx.has_pre else None, None)


_conv_epilogue.register_autograd(_backward, setup_context=_setup_context)


def conv_epilogue_pool(y: torch.Tensor, bias: torch.Tensor,
                       act: str = "none") -> torch.Tensor:
    return torch.ops.dvg_tpu_torch.conv_epilogue_pool(y, bias, act)


@torch.library.custom_op("dvg_tpu_torch::conv_epilogue_pool",
                         mutates_args=(), device_types="cpu")
def _conv_epilogue_pool(y: torch.Tensor, bias: torch.Tensor,
                        act: str) -> torch.Tensor:
    _check_pool(y, bias, act)
    return conv_epilogue_pool_plain(y, bias, act)


@_conv_epilogue_pool.register_kernel("cuda")
def _conv_epilogue_pool_cuda(y: torch.Tensor, bias: torch.Tensor,
                             act: str) -> torch.Tensor:
    _check_pool(y, bias, act)
    _check_cuda(y, bias, None)
    out = launch_pool(y, bias, act)
    conv_epilogue_pool.launches += 1
    conv_epilogue.launches += 1
    return out


@_conv_epilogue_pool.register_fake
def _conv_epilogue_pool_fake(y: torch.Tensor, bias: torch.Tensor,
                             act: str) -> torch.Tensor:
    _check_pool(y, bias, act)
    return _pooled_like(y)


def _raise_on(err: int) -> None:
    if err:
        raise RuntimeError(f"{KERNEL} kernel launch failed: cudaError {err}")


def _aligned(*ts: Optional[torch.Tensor]) -> bool:
    return all(t.data_ptr() % VECTOR_BYTES == 0 for t in ts if t is not None)


def launch(y: torch.Tensor, bias: torch.Tensor, pre: Optional[torch.Tensor],
           act: str, inner: int) -> torch.Tensor:
    """One launch of K3 on checked CUDA inputs (`inner` from `_check`) →
    out, of y's shape, dtype and strides. Counts nothing: `conv_epilogue`
    is the entry point; this is its launch, exposed for timing the kernel
    alone."""
    out = torch.empty_like(y)
    c = y.shape[1]
    vec = (inner == 1 and c % (VECTOR_BYTES // y.element_size()) == 0
           and _aligned(y, bias, pre, out))
    with torch.cuda.device(y.device):
        _raise_on(_lib().dvg_conv_epilogue(
            y.data_ptr(), 0 if pre is None else pre.data_ptr(),
            bias.data_ptr(), out.data_ptr(), y.numel(), c, inner,
            int(y.dtype == torch.bfloat16), ACTS[act], int(vec),
            torch.cuda.current_stream().cuda_stream))
    return out


def launch_pool(y: torch.Tensor, bias: torch.Tensor, act: str
                ) -> torch.Tensor:
    """One launch of K3's pooled form on checked channels_last CUDA inputs
    → the pooled map. Counts nothing: `conv_epilogue_pool` is the entry
    point; this is its launch, exposed for timing the kernel alone."""
    out = _pooled_like(y)
    n, c, h, w = y.shape
    vec = (c % (VECTOR_BYTES // y.element_size()) == 0
           and _aligned(y, bias, out))
    with torch.cuda.device(y.device):
        _raise_on(_lib().dvg_conv_epilogue_pool(
            y.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c, h, w,
            int(y.dtype == torch.bfloat16), ACTS[act], int(vec),
            torch.cuda.current_stream().cuda_stream))
    return out


conv_epilogue.launches = 0
conv_epilogue_pool.launches = 0
