"""K4, train-mode BatchNorm with per-call batch statistics fused with the
activation after it, forward and backward (`csrc/bn_act.cu`).

`bn_act(y, weight, bias, calls, act)` takes a conv's output y (calls·b, C,
H, W) holding `calls` batches of b, its BN scale and shift (C,) in y's
dtype, and an activation, "leaky_relu" (slope 0.2) or "tanh" (keys of
`ops.epilogue.ACTS`). Each call is normalized over its own (b, H, W) by its
biased variance, with the statistics and the affine in at least f32 (f64
stays f64) and one rounding to y's dtype before the activation:

    out = act(round((y − μ)·scale + β)),   scale = rsqrt(σ² + ε)·γ,

`dvg_tpu`'s batchnorm_apply followed by the activation. It returns (out,
(μ, unbiased σ²)), the statistics (calls, C) and detached, for the
running-statistics fold.

`bn_act_plain` is that composition in stock PyTorch ops, as the train
path ran it before the kernels, with the stock chain's autograd: the
operator runs it for a CPU tensor. `bn_act_backward_plain` is the kernels'
backward formula in PyTorch ops, the reference the backward kernels are
held to (and it to the stock chain's autograd):

    gz = act'(z)·g, rounded to y's dtype as the stock activation backward
         rounds it (z recomputed from y, or tanh's from out),
    dy = scale·((gz − Σgz/N) − (y − μ)·rstd²·Σ(gz·(y − μ))/N),
    dβ = Σ_calls Σgz,  dγ = Σ_calls rstd·Σ(gz·(y − μ)),

N = b·H·W. On a CUDA tensor the operator launches the kernels or raises
(a failed build or launch is an error, never a fallback), through a
`torch.autograd.Function`: two launches forward, the statistics and the
apply, and two backward, the sums and dy. What backward keeps is y, out
for tanh, and the (calls, C) vectors; under `no_grad` (or with nothing
requiring grad) the forward runs outside autograd and keeps nothing. It
never waits for the card. The kernels take
bf16, f32 and f64 maps in channels_last memory, with γ and β in y's dtype;
`_check` raises on anything else. `bn_act.launches` counts the kernels'
launches.

The statistics merge partial results across blocks through a persistent
int32 ticket array per device that each launch's last blocks leave at
zero again, so launches on one device are taken to run on one stream at a
time, as the train step issues them.

Like ops/epilogue.py, this module imports nothing of `models/`.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from dvg_tpu_torch.ops import _build
from dvg_tpu_torch.ops.epilogue import ACTS, NEGATIVE_SLOPE, activate

KERNEL = "bn_act"
EPS = 1e-5
# the kernels' activations, as keys of ops.epilogue.ACTS
BN_ACTS = ("leaky_relu", "tanh")
# the kernels' dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
VECTOR_BYTES = 16
MAX_THREADS = 512         # the kernels' __launch_bounds__
THREADS = 256             # a block's threads where a row has fewer units
BLOCKS_PER_SM = 8         # the grid's target: this many blocks an SM
MIN_ROWS = 8              # rows a thread visits at least, where there are

BNStats = Tuple[torch.Tensor, torch.Tensor]

_P, _I, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
# y, gamma, stats, part, tickets, calls, rows, c, dtype, vec, rpi, chunks,
# eps, unbias, stream
_STATS = [_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _D, _D, _P]
# y, mean, scale, beta, out, calls, rows, c, dtype, act, vec, rpi, chunks,
# stream
_APPLY = [_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P]
# y, g, out, stats, beta, sums, part, dgamma, dbeta, tickets, calls, rows,
# c, dtype, act, vec, rpi, chunks, stream
_BWD_SUMS = [_P] * 10 + [_I, _L, _I, _I, _I, _I, _I, _I, _P]
# y, g, out, stats, beta, sums, dy, calls, rows, c, dtype, act, vec, rpi,
# chunks, stream
_BWD = [_P] * 7 + [_I, _L, _I, _I, _I, _I, _I, _I, _P]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    for fn, sig in ((lib.dvg_bn_stats, _STATS), (lib.dvg_bn_apply, _APPLY),
                    (lib.dvg_bn_bwd_sums, _BWD_SUMS), (lib.dvg_bn_bwd, _BWD)):
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return lib


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _calls_view(t: torch.Tensor, calls: int) -> torch.Tensor:
    """(calls·b, C, H, W) → (calls, b, C, H, W)."""
    return t.unflatten(0, (calls, t.shape[0] // calls))


def _per_call(v: torch.Tensor) -> torch.Tensor:
    """(calls, C) → broadcastable over (calls, b, C, H, W)."""
    return v[:, None, :, None, None]


def bn_plain(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             calls: int, eps: float = EPS
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode BN without the activation, in stock ops: (out in y's
    dtype, stats (4, calls, C) in at least f32: μ, rstd = rsqrt(σ² + ε),
    scale = rstd·γ, unbiased σ²)."""
    at = acc_dtype(y.dtype)
    y5 = _calls_view(y, calls).to(at)
    n = y5.shape[1] * y5.shape[3] * y5.shape[4]
    var, mean = torch.var_mean(y5, dim=(1, 3, 4), correction=0)
    rstd = torch.rsqrt(var + eps)
    scale = rstd * weight.to(at)
    out = ((y5 - _per_call(mean)) * _per_call(scale)
           + bias.to(at)[:, None, None])
    unbiased = var * (n / max(n - 1, 1))
    return out.to(y.dtype).flatten(0, 1), torch.stack(
        [mean, rstd, scale, unbiased])


def bn_act_plain(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 calls: int, act: str, eps: float = EPS
                 ) -> Tuple[torch.Tensor, BNStats]:
    """The operator's function as the stock chain computes it, its autograd
    the chain's: `bn_plain`, then the activation in y's dtype."""
    out, stats = bn_plain(y, weight, bias, calls, eps)
    return activate(out, act), (stats[0].detach(), stats[3].detach())


def bn_act_backward_plain(g: torch.Tensor, y: torch.Tensor,
                          out: Optional[torch.Tensor], stats: torch.Tensor,
                          bias: torch.Tensor, calls: int, act: str
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The kernels' backward in PyTorch ops → (dy, dγ, dβ) in y's dtype,
    from the incoming gradient g, y, out (read for tanh) and `bn_plain`'s
    stats."""
    at = stats.dtype
    mean, rstd, scale = (_per_call(v) for v in stats[:3])
    y5 = _calls_view(y, calls).to(at)
    d = y5 - mean
    if act == "leaky_relu":
        z = (d * scale + bias.to(at)[:, None, None]).to(y.dtype).flatten(0, 1)
        gz = torch.ops.aten.leaky_relu_backward(g, z, NEGATIVE_SLOPE, False)
    else:
        gz = torch.ops.aten.tanh_backward(g, out)
    gz5 = _calls_view(gz, calls).to(at)
    n = y5.shape[1] * y5.shape[3] * y5.shape[4]
    s1 = gz5.sum((1, 3, 4))
    s2 = (gz5 * d).sum((1, 3, 4))
    m2 = rstd * rstd * _per_call(s2) / n
    dy = scale * ((gz5 - _per_call(s1) / n) - d * m2)
    return (dy.to(y.dtype).flatten(0, 1), (s2 * stats[1]).sum(0).to(y.dtype),
            s1.sum(0).to(y.dtype))


# ---------------------------------------------------------------------------
# checks and the launch geometry
# ---------------------------------------------------------------------------

def _check(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           calls: int, act: str) -> None:
    """Raises on what neither version takes; on the CPU too."""
    if act not in BN_ACTS:
        raise ValueError(f"act must be one of {BN_ACTS} (keys of "
                         f"ops.epilogue.ACTS {tuple(ACTS)}), got {act!r}")
    if y.dim() != 4:
        raise ValueError(f"expected an NCHW-shaped conv output, got "
                         f"{tuple(y.shape)}")
    if not isinstance(calls, int) or calls < 1 or y.shape[0] % calls:
        raise ValueError(f"{y.shape[0]} rows do not split into {calls!r} "
                         "calls")
    c = y.shape[1]
    for name, t in (("weight", weight), ("bias", bias)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} {tuple(t.shape)} does not match y's "
                             f"{c} channels")
        if t.dtype != y.dtype:
            raise TypeError(f"{name} is {t.dtype}, y {y.dtype}: both must "
                            "have y's dtype")
    devices = {t.device for t in (y, weight, bias)}
    if len(devices) != 1:
        raise ValueError(f"y, weight and bias on {sorted(map(str, devices))}"
                         ": all must be on one device")


def _check_cuda(y: torch.Tensor) -> None:
    if y.dtype not in DTYPES:
        raise TypeError(f"the kernels take float32, bfloat16 or float64, "
                        f"got {y.dtype}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"the kernels take channels_last y, got strides "
                         f"{y.stride()}")
    if y.numel() == 0:
        raise ValueError(f"y {tuple(y.shape)} is empty")


def geometry(calls: int, rows: int, units: int, sms: int
             ) -> Tuple[int, int]:
    """(rpi, chunks): rows an iteration of a block of rpi·units threads
    (`units` a row: C, or C over a vector's channels), and blocks a call,
    enough for BLOCKS_PER_SM blocks on each of `sms` SMs where every
    thread still visits MIN_ROWS rows."""
    if units > MAX_THREADS:
        raise ValueError(f"a row of {units} units exceeds a block of "
                         f"{MAX_THREADS} threads")
    rpi = max(1, THREADS // units)
    chunks = max(1, min(-(-sms * BLOCKS_PER_SM // calls),
                        rows // (rpi * MIN_ROWS)))
    return rpi, chunks


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_tickets: Dict[int, torch.Tensor] = {}
_tickets_lock = threading.Lock()


def _tickets_for(device: torch.device, n: int) -> torch.Tensor:
    """At least n int32 zeros on `device`, kept for every later launch (each
    launch's last blocks leave them at zero)."""
    with _tickets_lock:
        t = _tickets.get(device.index)
        if t is None or t.numel() < n:
            t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
            _tickets[device.index] = t
        return t


def _aligned(*ts: Optional[torch.Tensor]) -> bool:
    return all(t.data_ptr() % VECTOR_BYTES == 0 for t in ts if t is not None)


class _Launch:
    """The geometry one map's launches share."""

    def __init__(self, y: torch.Tensor, calls: int, *maps):
        self.c = y.shape[1]
        self.rows = (y.shape[0] // calls) * y.shape[2] * y.shape[3]
        lanes = VECTOR_BYTES // y.element_size()
        self.vec = self.c % lanes == 0 and _aligned(y, *maps)
        units = self.c // lanes if self.vec else self.c
        self.rpi, self.chunks = geometry(calls, self.rows, units,
                                         _sm_count(y.device.index))
        self.dtype = DTYPES[y.dtype]
        self.stream = torch.cuda.current_stream(y.device).cuda_stream


def _raise_on(err: int, which: str) -> None:
    if err:
        raise RuntimeError(f"{KERNEL} kernel {which} launch failed: "
                           f"cudaError {err}")


def launch_stats(y: torch.Tensor, weight: torch.Tensor, calls: int,
                 eps: float = EPS) -> torch.Tensor:
    """Kernel (a) on checked CUDA inputs → stats (4, calls, C) as
    `bn_plain`'s. Counts nothing: `bn_act` is the entry point."""
    g = _Launch(y, calls)
    stats = torch.empty((4, calls, g.c), dtype=acc_dtype(y.dtype),
                        device=y.device)
    part = torch.empty((3, calls, g.chunks, g.c), dtype=stats.dtype,
                       device=y.device)
    with torch.cuda.device(y.device):
        _raise_on(_lib().dvg_bn_stats(
            y.data_ptr(), weight.data_ptr(), stats.data_ptr(),
            part.data_ptr(), _tickets_for(y.device, calls + 1).data_ptr(),
            calls, g.rows, g.c, g.dtype, int(g.vec), g.rpi, g.chunks, eps,
            g.rows / max(g.rows - 1, 1), g.stream), "stats")
    return stats


def launch_apply(y: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, calls: int, act: str) -> torch.Tensor:
    """Kernel (b) on checked CUDA inputs, mean and scale (calls, C)
    contiguous in y's accumulation dtype → out. Counts nothing."""
    out = torch.empty_like(y)
    g = _Launch(y, calls, out)
    with torch.cuda.device(y.device):
        _raise_on(_lib().dvg_bn_apply(
            y.data_ptr(), mean.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), calls, g.rows, g.c, g.dtype, ACTS[act],
            int(g.vec), g.rpi, g.chunks, g.stream), "apply")
    return out


def launch_bwd_sums(g_out: torch.Tensor, y: torch.Tensor,
                    out: Optional[torch.Tensor], stats: torch.Tensor,
                    bias: torch.Tensor, calls: int, act: str
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel (c) on checked CUDA inputs (g_out channels_last, out read for
    tanh) → (sums (2, calls, C): Σgz and Σgz·(y − μ), dγ, dβ). Counts
    nothing."""
    o = out if act == "tanh" else y
    g = _Launch(y, calls, g_out, o)
    sums = torch.empty((2, calls, g.c), dtype=stats.dtype, device=y.device)
    part = torch.empty((2, calls, g.chunks, g.c), dtype=stats.dtype,
                       device=y.device)
    dgamma, dbeta = torch.empty_like(bias), torch.empty_like(bias)
    with torch.cuda.device(y.device):
        _raise_on(_lib().dvg_bn_bwd_sums(
            y.data_ptr(), g_out.data_ptr(), o.data_ptr(), stats.data_ptr(),
            bias.data_ptr(), sums.data_ptr(), part.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(),
            _tickets_for(y.device, calls + 1).data_ptr(), calls, g.rows, g.c,
            g.dtype, ACTS[act], int(g.vec), g.rpi, g.chunks, g.stream),
            "sums")
    return sums, dgamma, dbeta


def launch_bwd(g_out: torch.Tensor, y: torch.Tensor,
               out: Optional[torch.Tensor], stats: torch.Tensor,
               bias: torch.Tensor, sums: torch.Tensor, calls: int, act: str
               ) -> torch.Tensor:
    """Kernel (d) on checked CUDA inputs and (c)'s sums → dy. Counts
    nothing."""
    o = out if act == "tanh" else y
    dy = torch.empty_like(y)
    g = _Launch(y, calls, g_out, o, dy)
    with torch.cuda.device(y.device):
        _raise_on(_lib().dvg_bn_bwd(
            y.data_ptr(), g_out.data_ptr(), o.data_ptr(), stats.data_ptr(),
            bias.data_ptr(), sums.data_ptr(), dy.data_ptr(), calls, g.rows,
            g.c, g.dtype, ACTS[act], int(g.vec), g.rpi, g.chunks, g.stream),
            "dy")
    return dy


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

def _forward(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             calls: int, act: str, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernels (a) and (b) → (out, stats (4, calls, C))."""
    stats = launch_stats(y, weight, calls, eps)
    out = launch_apply(y, stats[0], stats[2], bias, calls, act)
    bn_act.launches += 2
    return out, stats


class _BNAct(torch.autograd.Function):
    """The kernels with their backward; CUDA tensors only."""

    @staticmethod
    def forward(ctx, y, weight, bias, calls, act, eps):
        out, stats = _forward(y, weight, bias, calls, act, eps)
        ctx.calls, ctx.act = calls, act
        ctx.save_for_backward(y, out if act == "tanh" else None, stats, bias)
        mean, var = stats[0], stats[3]
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _mean, _var):
        y, out, stats, bias = ctx.saved_tensors
        g = g.contiguous(memory_format=torch.channels_last)
        sums, dgamma, dbeta = launch_bwd_sums(g, y, out, stats, bias,
                                              ctx.calls, ctx.act)
        dy = launch_bwd(g, y, out, stats, bias, sums, ctx.calls, ctx.act)
        bn_act.launches += 2
        return dy, dgamma, dbeta, None, None, None


def bn_act(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           calls: int, act: str, eps: float = EPS
           ) -> Tuple[torch.Tensor, BNStats]:
    """The operator (module docstring) → (out, (μ, unbiased σ²))."""
    _check(y, weight, bias, calls, act)
    if y.device.type != "cuda":
        return bn_act_plain(y, weight, bias, calls, act, eps)
    _check_cuda(y)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, weight, bias)):
        out, mean, var = _BNAct.apply(y, weight, bias, calls, act, eps)
        return out, (mean, var)
    out, stats = _forward(y, weight, bias, calls, act, eps)
    return out, (stats[0], stats[3])


bn_act.launches = 0
