"""K4's operator (`dvg_tpu_torch/ops/batchnorm.py`) on the CPU: there it
runs the plain composition the train path ran before it
(`layers.batch_norm_train`, then the activation), forward and gradients
bitwise; the kernels' backward formula (`bn_act_backward_plain`) against
that chain's autograd to rounding, in bf16, f32 and f64, over several
calls, both activations and the 90-channel encoder head; the refusals, the
launch geometry, every BatchNorm of the train step routed through the
operator, and the kernels' names in the benchmark's frozen groups. The
kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import pytest
import torch

from benchmark.metrics import reader
from benchmark.yardstick.trace import TRAIN_GROUPS, Trace, group_of
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.models import layers as L
from dvg_tpu_torch.ops import batchnorm as BN
from dvg_tpu_torch.ops.epilogue import activate

SOURCE = Path(BN.__file__).resolve().parent.parent / "csrc" / "bn_act.cu"
# (calls·b, C, H, W, calls): three calls of a small map; the 90-channel
# encoder head (1×1) in two calls; one call
SHAPES = [(12, 16, 5, 6, 3), (8, 90, 1, 1, 2), (4, 24, 3, 3, 1)]
# the gradients' allowance, relative to the largest |gradient|: a few
# roundings of the dtype the chain's f32 (f64) steps run in; bf16 gradients
# are the same bf16 values or one bf16 rounding apart
GRAD_RTOL = {torch.float64: 1e-13, torch.float32: 1e-6,
             torch.bfloat16: 2.0 ** -7}


def _inputs(shape, dtype, seed=0):
    n, c, h, w, calls = shape
    g = torch.Generator().manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, dtype=torch.float64)
    y = (randn(n, c, h, w) * 2 + 0.5).to(dtype).contiguous(
        memory_format=torch.channels_last)
    weight = (1 + 0.3 * randn(c)).to(dtype)
    bias = (0.2 * randn(c)).to(dtype)
    return y, weight, bias, randn(n, c, h, w).to(dtype), calls


def _run(fn, y, weight, bias, grad):
    leaves = [t.clone().requires_grad_() for t in (y, weight, bias)]
    out, (mean, var) = fn(*leaves)
    out.backward(grad)
    return out.detach(), mean, var, tuple(t.grad for t in leaves)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("act", BN.BN_ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_operator_and_the_kernels_formula_against_the_composition(
        dtype, act, shape):
    y, weight, bias, grad, calls = _inputs(shape, dtype)

    def composition(y, w, b):
        out, stats = L.batch_norm_train(y, w, b, calls)
        return activate(out, act), stats
    before = BN.bn_act.launches
    got = _run(lambda y, w, b: BN.bn_act(y, w, b, calls, act), y, weight,
               bias, grad)
    want = _run(composition, y, weight, bias, grad)
    assert BN.bn_act.launches == before          # the CPU launches nothing
    for g, w in zip(got[:3] + tuple(got[3]), want[:3] + tuple(want[3])):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[1].shape == (calls, shape[1])
    _, stats = BN.bn_plain(y, weight, bias, calls)
    formula = BN.bn_act_backward_plain(grad, y, want[0], stats, bias, calls,
                                       act)
    for g, w in zip(formula, want[3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = w.double().abs().max().clamp(min=1e-30)
        err = ((g.double() - w.double()).abs().max() / scale).item()
        assert err <= GRAD_RTOL[dtype], (act, shape, err)


def test_refusals():
    y, weight, bias, _, calls = _inputs((6, 8, 2, 2, 3), torch.float32)
    with pytest.raises(ValueError, match="act must be one of"):
        BN.bn_act(y, weight, bias, calls, "sigmoid")
    with pytest.raises(TypeError, match="y's dtype"):
        BN.bn_act(y, weight.double(), bias, calls, "tanh")
    with pytest.raises(ValueError, match="do not split"):
        BN.bn_act(y, weight, bias, 4, "tanh")
    with pytest.raises(ValueError, match="does not match"):
        BN.bn_act(y, weight[:4], bias, calls, "tanh")
    with pytest.raises(ValueError, match="NCHW-shaped"):
        BN.bn_act(y[0], weight, bias, calls, "tanh")
    with pytest.raises(ValueError, match="one device"):
        BN.bn_act(y, weight.to("meta"), bias, calls, "tanh")
    # what only the kernels refuse, checked before any launch
    with pytest.raises(TypeError, match="float32, bfloat16 or float64"):
        BN._check_cuda(y.half())
    with pytest.raises(ValueError, match="channels_last"):
        BN._check_cuda(y.contiguous())
    with pytest.raises(ValueError, match="exceeds a block"):
        BN.geometry(1, 100, BN.MAX_THREADS + 1, 132)


@pytest.mark.parametrize("calls,rows,units,rpi,chunks", [
    (42, 100 * 32 * 32, 8, 32, 26),      # decode, 64 channels at 32×32
    (15, 100 * 32 * 32, 8, 32, 71),      # encode, the same map
    (42, 100 * 4 * 4, 64, 4, 26),        # decode head, 512 channels
    (15, 100, 90, 2, 6),                 # encoder head, C 90, scalar
    (1, 3, 512, 1, 1)])                  # one row a call
def test_geometry_fills_the_card(calls, rows, units, rpi, chunks):
    """On 132 SMs: blocks of rpi·units ≤ 512 threads, about eight blocks an
    SM where every thread still visits MIN_ROWS rows."""
    got = BN.geometry(calls, rows, units, 132)
    assert got == (rpi, chunks)
    assert rpi * units <= BN.MAX_THREADS


def test_every_train_batchnorm_goes_through_the_operator(monkeypatch):
    """One tiny train step calls the operator once per BN forward: the
    joint encode and the grouped decode with grad, the finetune encode
    without (DCGAN-64: 5 + 4 with grad, 5 without; the 46 launches a
    step on the card are twice each forward plus twice each backward)."""
    from dvg_tpu_torch.parallel.dryrun import TINY
    from dvg_tpu_torch.train import init_train_state, make_train_step
    cfg = DVGConfig(**dict(TINY, batch_size=2, n_past=2,
                           n_future=1, g_dim=8, rnn_size=16,
                           num_inducing_points=4))
    state = init_train_state(cfg, device="cpu")
    calls = []
    inner = BN.bn_act

    def counted(y, *args, **kw):
        calls.append(torch.is_grad_enabled())
        return inner(y, *args, **kw)
    monkeypatch.setattr(BN, "bn_act", counted)
    x = torch.rand((cfg.seq_len_train, cfg.batch_size, 64, 64, 1),
                   generator=torch.Generator().manual_seed(0))
    make_train_step(cfg)(state, x)
    enc = len(state.model.encoder.bn_blocks())
    dec = len(state.model.decoder.bn_blocks())
    assert (enc, dec) == (5, 4)
    assert calls == [True] * (enc + dec) + [False] * enc
    assert 2 * len(calls) + 2 * (enc + dec) == 46


def test_kernel_names_fall_in_the_elementwise_group():
    """The kernels' symbols, read from their source, hold
    `dvg_elementwise_bn` and no earlier key of the frozen TRAIN_GROUPS, so
    the train breakdown classes K4 as the elementwise work it replaces and
    `bn_act_launches_per_step.train` counts all four."""
    source = SOURCE.read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?\n?(\w+)\s*\(", source)
    assert names == ["dvg_elementwise_bn_stats", "dvg_elementwise_bn_apply",
                     "dvg_elementwise_bn_bwd_sums", "dvg_elementwise_bn_bwd"]
    params = ("(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
              "float*, unsigned int*, long long, int, int, double, double)")
    traced = [f"void (anonymous namespace)::{name}<__nv_bfloat16, 1, true>"
              + params for name in names]
    for name in traced:
        assert group_of(name, TRAIN_GROUPS) == "elementwise", name
        assert "dvg_elementwise_epilogue" not in name
    read = reader("bn_act_launches_per_step.train")
    spans = [("bench.window", 0.0, 100.0)]
    kernels = [(traced[i % 4], 10.0 * i, 10.0 * i + 5) for i in range(8)]
    assert read(Trace(kernels + [("sm90_wgrad", 1.0, 2.0)], [], spans, [],
                      2), {}) == 4.0
    assert read(Trace([("sm90_wgrad", 1.0, 2.0)], [], spans, [], 2),
                {}) is None
