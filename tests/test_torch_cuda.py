"""The port's hand-written kernels on the card, against their plain
versions, and the card's generation and checkpoint paths against the CPU's.
Imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test here needs a CUDA card and nvcc (marker `gpu`) and skips
without one; the CPU parity of the same code is in the other
tests/test_torch_*.py files. Tolerances as chip_smoke.py states them:
K1 and K2 against plain SSIM atol 1e-4, PSNR atol 1e-3 dB, MSE rtol 1e-5;
the tiny f32 slice card against CPU SSIM 1e-4, PSNR 1e-3 dB, MSE rtol 1e-4;
K4 (train-mode BatchNorm and its activation) at the DCGAN-64 train cell's
maps, statistics rtol 1e-5 of the plain chain's, the apply bitwise given
them, gradients against the plain formula within a bf16 rounding (f32
1e-5) of the largest;
gp_trigger card against CPU equal masks, frames atol 1e-4, values rtol
1e-4; the tiny train step on the card (f64 and f32) against the CPU's f64
step as chip_smoke.py's `phase_train_tiny` holds it; a TrainState written
and read back on the card; a tiny reference-schema `.pth` imported and
run (f32 posterior) on the card against the same file on the CPU and
against the reference's loop over the unpickled modules, frames atol
1e-4; the parallel layer on the card (chip_smoke.py's [dist] jobs): NCCL
at world size 1, and two gloo ranks sharing the card for the sharded
eval."""

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
# K3: the conv epilogue
# ---------------------------------------------------------------------------

# (shape, dtype, layout): the VGG-128 cell's largest map (a full-resolution
# 64-channel conv output of 800 frames) and its 3-channel final conv
# (scalar path); in f32 a 64-channel map (vector path, 4 a vector) and the
# 90-channel encoder head (scalar); the 1×1 → 4×4 decoder head as
# contiguous NCHW; a channel count that is a multiple of 4 but not of 8
EPILOGUE_CASES = [((800, 64, 128, 128), torch.bfloat16, "channels_last"),
                  ((800, 3, 128, 128), torch.bfloat16, "channels_last"),
                  ((64, 64, 64, 64), torch.float32, "channels_last"),
                  ((800, 90, 1, 1), torch.float32, "channels_last"),
                  ((800, 512, 4, 4), torch.bfloat16, "nchw"),
                  ((16, 12, 32, 32), torch.bfloat16, "channels_last")]


def _epilogue_inputs(dev, shape, dtype, layout, seed=0):
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)
    return (rand(*shape).contiguous(memory_format=fmt), rand(shape[1]),
            rand(*shape).contiguous(memory_format=fmt))


def _epilogue_close(got, ref, act):
    """none and leaky_relu bitwise; tanh and sigmoid within 1 bf16 ulp
    (2⁻⁷ of the value bounds it) or 1e-6 in f32."""
    assert got.dtype == ref.dtype and got.stride() == ref.stride()
    if act in ("none", "leaky_relu"):
        assert torch.equal(got, ref), act
        return
    d = (got.float() - ref.float()).abs()
    tol = (2.0 ** -7 * ref.float().abs() if got.dtype == torch.bfloat16
           else torch.full_like(d, 1e-6))
    assert (d <= tol).all(), (act, d.max().item())


@pytest.mark.parametrize("shape,dtype,layout", EPILOGUE_CASES)
@pytest.mark.parametrize("with_pre", [False, True])
def test_epilogue_kernel_matches_plain(cuda, shape, dtype, layout, with_pre):
    from dvg_tpu_torch.ops import epilogue as E
    y, bias, pre = _epilogue_inputs(cuda, shape, dtype, layout)
    pre = pre if with_pre else None
    for act in E.ACTS:
        before = E.conv_epilogue.launches
        got = E.conv_epilogue(y, bias, pre, act)
        torch.cuda.synchronize()
        assert E.conv_epilogue.launches == before + 1
        _epilogue_close(got, E.conv_epilogue_plain(y, bias, pre, act), act)
        del got
    torch.cuda.empty_cache()


def test_epilogue_misaligned_and_cpu_paths(cuda):
    """Storage off a 16-byte boundary takes the scalar path; a CPU call runs
    the plain version and launches nothing."""
    from dvg_tpu_torch.ops import epilogue as E
    y, bias, pre = _epilogue_inputs(cuda, (4, 16, 8, 8), torch.bfloat16,
                                    "nchw")
    y, pre = _misaligned(y), _misaligned(pre)
    got = E.conv_epilogue(y, bias, pre, "leaky_relu")
    _epilogue_close(got, E.conv_epilogue_plain(y, bias, pre, "leaky_relu"),
                    "leaky_relu")
    before = E.conv_epilogue.launches
    cpu = E.conv_epilogue(y.cpu(), bias.cpu(), pre.cpu(), "leaky_relu")
    assert E.conv_epilogue.launches == before
    assert torch.equal(cpu, got.cpu())


def test_epilogue_refuses_what_it_does_not_take(cuda):
    from dvg_tpu_torch.ops import epilogue as E
    y, bias, pre = _epilogue_inputs(cuda, (2, 16, 8, 8), torch.float32,
                                    "channels_last")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        E.conv_epilogue(y.double(), bias.double(), None, "none")
    with pytest.raises(TypeError, match="bias must be"):
        E.conv_epilogue(y, bias.bfloat16(), None, "none")
    with pytest.raises(ValueError, match="one CUDA device"):
        E.conv_epilogue(y, bias.cpu(), None, "none")
    with pytest.raises(ValueError, match="pre's strides"):
        E.conv_epilogue(y, bias, pre.contiguous(), "none")


# K3's pooled form at the VGG-128 eval's five pooled maps (each encoder
# group's last conv output at 800 frames), bf16 channels_last; in f32 an odd
# size (the last row and column dropped); a channel count that is not a
# multiple of 8 (scalar path)
POOL_CASES = [((800, 64, 128, 128), torch.bfloat16),
              ((800, 128, 64, 64), torch.bfloat16),
              ((800, 256, 32, 32), torch.bfloat16),
              ((800, 512, 16, 16), torch.bfloat16),
              ((800, 512, 8, 8), torch.bfloat16),
              ((16, 64, 33, 31), torch.float32),
              ((16, 12, 32, 32), torch.bfloat16)]


@pytest.mark.parametrize("shape,dtype", POOL_CASES)
def test_pooled_epilogue_kernel_matches_plain(cuda, shape, dtype):
    """Bitwise for none and leaky_relu, against the plain version and
    against max_pool2d of the plain epilogue; tanh and sigmoid as K3's."""
    import torch.nn.functional as F
    from dvg_tpu_torch.ops import epilogue as E
    y, bias, _ = _epilogue_inputs(cuda, shape, dtype, "channels_last")
    for act in E.ACTS:
        before = (E.conv_epilogue.launches, E.conv_epilogue_pool.launches)
        got = E.conv_epilogue_pool(y, bias, act)
        torch.cuda.synchronize()
        assert (E.conv_epilogue.launches,
                E.conv_epilogue_pool.launches) == (before[0] + 1,
                                                   before[1] + 1)
        _epilogue_close(got, E.conv_epilogue_pool_plain(y, bias, act), act)
        if act in ("none", "leaky_relu"):
            assert torch.equal(got, F.max_pool2d(
                E.conv_epilogue_plain(y, bias, None, act), 2, 2))
        del got
    torch.cuda.empty_cache()


def test_pooled_epilogue_misaligned_and_refusals(cuda):
    """Storage off a 16-byte boundary takes the scalar path; NCHW y and a
    bias of another dtype are refused."""
    from dvg_tpu_torch.ops import epilogue as E
    y, bias, _ = _epilogue_inputs(cuda, (4, 16, 8, 8), torch.bfloat16,
                                  "channels_last")
    y = _misaligned(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert y.is_contiguous(memory_format=torch.channels_last)
    got = E.conv_epilogue_pool(y, bias, "leaky_relu")
    assert torch.equal(got, E.conv_epilogue_pool_plain(y, bias,
                                                       "leaky_relu"))
    with pytest.raises(ValueError, match="channels_last"):
        E.conv_epilogue_pool(y.contiguous(), bias, "none")
    with pytest.raises(TypeError, match="bias must be"):
        E.conv_epilogue_pool(y, bias.float(), "none")


def test_folded_up_halves_come_out_channels_last(cuda):
    """On the prepared bf16 VGG-128 model each folded transposed conv gives
    channels_last, so the epilogue copies nothing."""
    from dvg_tpu_torch.models import layers as L
    cfg = DVGConfig(**dict(TINY, model="vgg", image_width=128,
                           dtype="bfloat16"))
    p = make_rollout_fns(DVGModel(cfg, seed=0, device=cuda), cfg).prepare()
    dec = p.model.decoder
    for i, up in enumerate(dec.up):
        side = 4 * 2 ** i
        d = torch.randn((8, up.in_channels, side, side), device=cuda,
                        dtype=torch.bfloat16).contiguous(
                            memory_format=torch.channels_last)
        y = L.conv_apply(up, d, bias=False)
        assert y.shape == (8, up.out_channels, 2 * side, 2 * side)
        assert y.is_contiguous(memory_format=torch.channels_last), i


# ---------------------------------------------------------------------------
# K4: train-mode BatchNorm and its activation
# ---------------------------------------------------------------------------

# (shape, calls): the DCGAN-64 train cell's maps, B 100: the encode's first
# stage (15 frames) and the grouped decode's last (42 calls), the 90-channel
# encoder head (scalar path) and the decoder head
BN_CASES = [((1500, 64, 32, 32), 15), ((4200, 64, 32, 32), 42),
            ((1500, 90, 1, 1), 15), ((4200, 512, 4, 4), 42)]
# statistics against the plain chain's on the card: a few f32 roundings
# (both Welford, merged in other orders); gradients against the plain
# formula on the kernels' own statistics, relative to the largest
# |gradient|: f32 sums in other orders, and in bf16 one rounding
BN_STATS_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5,
                 torch.float64: 1e-12}
BN_GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
                torch.float64: 1e-12}


def _bn_inputs(dev, shape, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev)
    y = (randn(*shape) * 2 + 0.5).to(dtype).contiguous(
        memory_format=torch.channels_last)
    return (y, (1 + 0.3 * randn(shape[1])).to(dtype),
            (0.2 * randn(shape[1])).to(dtype),
            randn(*shape).to(dtype).contiguous(
                memory_format=torch.channels_last))


def _rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def _bn_check(y, weight, bias, grad, calls, act):
    """K4 against the plain versions on the card: the statistics to
    BN_STATS_RTOL of the plain chain's; the apply bitwise given the plain
    statistics (tanh within K3's allowance); the operator's output the
    apply of its own statistics, its backward the plain formula's on them
    (BN_GRAD_RTOL); four launches, dy channels_last."""
    from dvg_tpu_torch.ops import batchnorm as BN
    dtype = y.dtype
    plain_out, plain = BN.bn_plain(y, weight, bias, calls)
    stats = BN.launch_stats(y, weight, calls)
    for i in range(4):
        assert _rel(stats[i], plain[i]) <= BN_STATS_RTOL[dtype], (act, i)
    _epilogue_close(
        BN.launch_apply(y, plain[0].contiguous(), plain[2].contiguous(), bias,
                        calls, act),
        BN.activate(plain_out, act), "none" if act == "leaky_relu" else act)
    leaves = [y.detach().requires_grad_()] + [
        t.clone().requires_grad_() for t in (weight, bias)]
    before = BN.bn_act.launches
    out, (mean, var) = BN.bn_act(*leaves, calls, act)
    out.backward(grad)
    torch.cuda.synchronize()
    assert BN.bn_act.launches == before + 4
    assert torch.equal(out, BN.launch_apply(y, stats[0], stats[2], bias,
                                            calls, act))
    assert torch.equal(mean, stats[0]) and torch.equal(var, stats[3])
    want = BN.bn_act_backward_plain(grad, y, out.detach(), stats, bias,
                                    calls, act)
    for got, ref in zip((t.grad for t in leaves), want):
        assert got.dtype == ref.dtype
        assert _rel(got, ref) <= BN_GRAD_RTOL[dtype], act
    assert leaves[0].grad.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,calls", BN_CASES)
def test_bn_act_kernels_match_plain(cuda, shape, calls, dtype):
    """`_bn_check` at the train cell's maps, both activations; the tickets
    left at zero."""
    from dvg_tpu_torch.ops import batchnorm as BN
    y, weight, bias, grad = _bn_inputs(cuda, shape, dtype)
    for act in BN.BN_ACTS:
        _bn_check(y, weight, bias, grad, calls, act)
    assert not BN._tickets[torch.cuda.current_device()].any()
    torch.cuda.empty_cache()


def test_bn_act_scalar_path_f64_checkpoint_and_refusals(cuda):
    """Storage off a 16-byte boundary and C not a multiple of the vector
    take the scalar path, f64 (the tiny f64 train step's) both; a rerun
    under checkpoint gives the same gradients; no_grad launches the
    forward alone; NCHW y and f16 are refused."""
    from torch.utils.checkpoint import checkpoint
    from dvg_tpu_torch.ops import batchnorm as BN
    for dtype, shape in ((torch.bfloat16, (12, 16, 5, 6)),
                         (torch.float32, (6, 90, 3, 3)),
                         (torch.float64, (12, 16, 5, 6)),
                         (torch.float64, (12, 16, 1, 1))):
        y, weight, bias, grad = _bn_inputs(cuda, shape, dtype, seed=1)
        if shape[2] > 1:
            y = _misaligned(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            assert not BN._Launch(y, 3).vec
        assert y.is_contiguous(memory_format=torch.channels_last)
        for act in BN.BN_ACTS:
            _bn_check(y, weight, bias, grad, 3, act)
    y, weight, bias, grad = _bn_inputs(cuda, (8, 16, 4, 4), torch.float32)
    leaves = [t.clone().requires_grad_() for t in (y, weight, bias)]
    BN.bn_act(*leaves, 2, "leaky_relu")[0].backward(grad)
    again = [t.clone().requires_grad_() for t in (y, weight, bias)]
    before = BN.bn_act.launches
    checkpoint(lambda *t: BN.bn_act(*t, 2, "leaky_relu")[0], *again,
               use_reentrant=False).backward(grad)
    assert BN.bn_act.launches == before + 6
    for a, b in zip(again, leaves):
        assert torch.equal(a.grad, b.grad)
    before = BN.bn_act.launches
    with torch.no_grad():
        BN.bn_act(*leaves, 2, "tanh")
    assert BN.bn_act.launches == before + 2
    with pytest.raises(ValueError, match="channels_last"):
        BN.bn_act(y.contiguous(), weight, bias, 2, "tanh")
    with pytest.raises(TypeError, match="float32, bfloat16 or float64"):
        BN.bn_act(y.half(), weight.half(), bias.half(), 2, "tanh")


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_and_prepare_never_wait_on_the_card(cuda, dtype):
    """At __graft_entry__._tiny_cfg (its fields as parallel.dryrun.TINY),
    after one warm-up step (it builds the step's plan and cuDNN's
    choices), two steps and one prepare() run under
    torch.cuda.set_sync_debug_mode("error"): no call in them waits for the
    card, so the host can run ahead of it and the step can be captured."""
    from dvg_tpu_torch.parallel.dryrun import TINY as GRAFT_TINY
    cfg = DVGConfig(**dict(GRAFT_TINY, dtype=dtype, seed=3))
    state = init_train_state(cfg, device="cuda")
    step = make_train_step(cfg)
    fns = make_rollout_fns(state.model, cfg)
    x = torch.rand((cfg.seq_len_train, cfg.batch_size, cfg.image_width,
                    cfg.image_width, cfg.channels),
                   generator=torch.Generator(device="cuda").manual_seed(3),
                   device="cuda")
    step(state, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            _, metrics = step(state, x)
        prep = fns.prepare()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == 3
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(bool(torch.isfinite(t).all()) for t in prep.cache32)


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


def test_world1_nccl_step_and_sharded_eval(cuda, tmp_path):
    """chip_smoke.py's [dist] (a) as a test: NCCL at world size 1 on the
    card, the tiny f64 step through the group path against the same step
    without a group (metrics and gradients 1e-12, post-step state 1e-9),
    and the ("sample", 1)-sharded tiny eval equal to the plain call, K1
    launched once per free step."""
    import chip_smoke
    torch.save(chip_smoke.dist_spec(), tmp_path / "dist_spec.pt")
    (res,) = chip_smoke.dist_spawn(tmp_path, "nccl1", 1)
    assert res["backend"] == "nccl"
    assert max(res["step_errors"].values()) <= 0, res["step_errors"]
    assert res["eval_errs"][3] <= 1e-12
    tiny = chip_smoke.DIST_TINY_EVAL
    assert res["launches"] == tiny["n_eval"] - tiny["n_past"]


def test_two_gloo_ranks_share_the_card_for_the_sharded_eval(cuda, tmp_path):
    """Two ranks on the one card over gloo, CUDA tensors: the ("sample",
    2)-sharded tiny f32 eval gathers the one-process eval on every rank
    (SSIM 1e-5, PSNR 1e-3 dB, MSE rtol 1e-5), K1 launched once per free
    step on each rank; without a data axis full_cov stays legal."""
    import chip_smoke
    spec = chip_smoke.dist_spec()
    torch.save(spec, tmp_path / "dist_spec.pt")
    ranks = chip_smoke.dist_spawn(tmp_path, "tiny_eval", 2)
    tiny = chip_smoke.DIST_TINY_EVAL
    ref = chip_smoke._tiny_eval_fns(spec, tiny["nsample"]).diverse_metrics(
        spec["x_eval"], seed=chip_smoke.DIST_TINY_SEED, device="cuda")
    for r in ranks:
        assert r["backend"] == "gloo" and r["guard"] == "no error"
        assert r["launches"] == tiny["n_eval"] - tiny["n_past"]
        errs = chip_smoke.max_errs(
            [r["metrics"][k] for k in chip_smoke.METRICS],
            [ref[k].cpu() for k in chip_smoke.METRICS])
        assert chip_smoke.within(errs, chip_smoke.DIST_F32_TOL), errs


# ---------------------------------------------------------------------------
# serving: the custom ops and a tiny artifact on the card
# ---------------------------------------------------------------------------

def test_custom_ops_on_card_match_plain_and_count(cuda):
    """`torch.ops.dvg_tpu_torch.ssim_cyclic` and `ssim_images`, called as an
    exported program calls them, launch the kernels (counted) and match the
    plain versions."""
    gt, pred = _pair(cuda, 4, 3, 3, torch.bfloat16)
    for op, wrapper, p, ref in (
            (torch.ops.dvg_tpu_torch.ssim_cyclic, ssim_psnr_batch_cyclic,
             pred, plain.ssim_psnr_cyclic_plain(gt, pred)),
            (torch.ops.dvg_tpu_torch.ssim_images, ssim_psnr_batch_images,
             pred[:4], plain.ssim_psnr_images_plain(gt, pred[:4]))):
        before = wrapper.launches
        got = op(gt, p)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _close(got, ref, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        torch.ops.dvg_tpu_torch.ssim_cyclic(gt, pred.transpose(1, 2))


def test_tiny_artifact_on_card_equals_live(cuda, tmp_path):
    """A tiny f32 diverse_metrics artifact exported for the card, loaded
    and called: K1 launched once per free step from inside the program,
    and the live entry's metrics (SSIM 1e-5, PSNR 1e-3 dB, MSE rtol
    1e-5)."""
    from dvg_tpu_torch.serve import export_serving, load_serving
    cfg = DVGConfig(**TINY)
    ckpt = save_checkpoint(str(tmp_path), cfg,
                           DVGModel(cfg, seed=0, device="cuda"))
    path = export_serving(ckpt, str(tmp_path / "dm.pt2"),
                          entry="diverse_metrics", nsample=3, batch_size=2,
                          n_eval=17)
    served = load_serving(path)
    x = torch.rand((17, 2, 64, 64, 3), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(4))
    before = ssim_psnr_batch_cyclic.launches
    got = served(x, 6)
    torch.cuda.synchronize()
    assert ssim_psnr_batch_cyclic.launches == before + 15
    _, model = load_model(ckpt, device="cuda")
    ref = make_rollout_fns(model, cfg).diverse_metrics(x, seed=6)
    _close([got[k] for k in ("ssim", "psnr", "mse")],
           [ref[k] for k in ("ssim", "psnr", "mse")], 1e-5)
