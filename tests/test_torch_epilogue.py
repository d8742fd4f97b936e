"""The conv epilogue (`dvg_tpu_torch/ops/epilogue.py`, K3 on the card) on
the CPU, where the op runs its plain version:

  * the plain version against the composition it replaces (conv bias,
    skip-half add, activation as separate ops): equal in f32, and within
    one bf16 rounding of the inputs' magnitude in bf16, where it is the f32
    result rounded once;
  * its autograd formula against torch's, in f64;
  * folded VGG-128 and DCGAN-64 encode, fused decode and hoisted decode
    against the same models run through that composition;
  * the layouts and strides the wrapper refuses, the launch counter, the
    export of a folded block, and the kernel's name in the benchmark's
    elementwise group.

The kernel against the plain version on the card: tests/test_torch_cuda.py.
"""

import copy
import itertools
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark.metrics import reader
from benchmark.yardstick.trace import (ELEMENTWISE, KERNEL_GROUPS, Trace,
                                       group_of)
from dvg_tpu_torch.models import dcgan, vgg
from dvg_tpu_torch.models import layers as L
from dvg_tpu_torch.ops import epilogue as E
from dvg_tpu_torch.ops.epilogue import conv_epilogue

SOURCE = Path(E.__file__).resolve().parent.parent / "csrc" / "conv_epilogue.cu"
LAYOUTS = {"channels_last": torch.channels_last,
           "nchw": torch.contiguous_format}
OLD_ACT = {"none": lambda x: x, "leaky_relu": L.leaky_relu,
           "tanh": torch.tanh, "sigmoid": torch.sigmoid}
BF16_EPS = 2.0 ** -8        # a bf16 rounding: half an ulp, relative


def _inputs(layout, dtype, pre, shape=(3, 16, 5, 7), seed=0):
    g = torch.Generator().manual_seed(seed)
    fmt = LAYOUTS[layout]
    y = torch.randn(shape, generator=g).to(dtype).to(memory_format=fmt)
    p = (torch.randn(shape, generator=g).to(dtype).to(memory_format=fmt)
         if pre else None)
    return y, torch.randn(shape[1], generator=g).to(dtype), p


def _composition(y, bias, pre, act):
    """What the eval paths ran before the epilogue, in y's dtype: the skip
    add, the bias add and the activation, each rounding."""
    z = y if pre is None else y + pre
    return OLD_ACT[act](z + bias[:, None, None])


@pytest.mark.parametrize("act,pre,layout,dtype", list(itertools.product(
    E.ACTS, (False, True), LAYOUTS, (torch.float32, torch.bfloat16))))
def test_plain_version_against_the_composition(act, pre, layout, dtype):
    y, bias, p = _inputs(layout, dtype, pre)
    got = conv_epilogue(y, bias, p, act)
    assert got.dtype == dtype and got.shape == y.shape
    assert got.stride() == y.stride()
    old = _composition(y, bias, p, act)
    if dtype == torch.float32:
        assert torch.equal(got, old)
        return
    f32 = _composition(y.float(), bias.float(),
                       None if p is None else p.float(), act)
    assert torch.equal(got, f32.to(dtype))          # one rounding
    scale = (y.float().abs() + bias.float().abs()[:, None, None]
             + (0 if p is None else p.float().abs()))
    # the composition's roundings of the sum, then its output's ulp
    assert ((got.float() - old.float()).abs()
            <= BF16_EPS * scale + 2 * BF16_EPS * got.float().abs()).all()


@pytest.mark.parametrize("act", list(E.ACTS))
def test_backward_matches_autograd_of_the_composition(act):
    y, bias, p = (t.double().requires_grad_() for t in
                  _inputs("channels_last", torch.float32, True))
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    want = torch.autograd.grad(_composition(y, bias, p, act), (y, bias, p), g)
    got = torch.autograd.grad(conv_epilogue(y, bias, p, act), (y, bias, p), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


# -- the wiring: folded backbones against the composition --------------------

def _old_block(block, h, act):
    return OLD_ACT[act](block.conv(h))


def _old_vgg_encode(enc, x):
    h, skips = L.nchw(x), []
    for i, group in enumerate(enc.groups):
        h = L.max_pool2d(h) if i else h
        for block in group:
            h = _old_block(block, h, "leaky_relu")
        skips.append(L.nhwc(h))
    h = _old_block(enc.head, L.max_pool2d(h), "tanh")
    return h.reshape(h.shape[0], -1), skips


def _old_vgg_decode(dec, vec, skips):
    d = _old_block(dec.head, vec[:, :, None, None], "leaky_relu")
    for group, skip in zip(dec.groups, reversed(skips)):
        d = torch.cat([L.upsample_nearest2d(d), L.nchw(skip)], dim=1)
        for block in group:
            d = _old_block(block, d, "leaky_relu")
    return L.nhwc(torch.sigmoid(dec.final(d)))


def _old_vgg_hoisted(dec, vec, skip_pre):
    d = _old_block(dec.head, vec[:, :, None, None], "leaky_relu")
    for group, pre in zip(dec.groups, skip_pre):
        up = L.upsample_nearest2d(d)
        conv = group[0].conv
        y = F.conv2d(up, conv.weight[:, :up.shape[1]], None, 1, 1)
        d = L.leaky_relu(y + L.nchw(pre) + conv.bias[:, None, None])
        for block in group[1:]:
            d = _old_block(block, d, "leaky_relu")
    return L.nhwc(torch.sigmoid(dec.final(d)))


def _old_dcgan_encode(enc, x):
    h, skips = L.nchw(x), []
    for stage in enc.stages:
        h = _old_block(stage, h, "leaky_relu")
        skips.append(L.nhwc(h))
    h = _old_block(enc.head, h, "tanh")
    return h.reshape(h.shape[0], -1), skips


def _old_dcgan_decode(dec, vec, skips):
    d = _old_block(dec.head, vec[:, :, None, None], "leaky_relu")
    for stage, skip in zip(dec.stages, reversed(skips)):
        d = _old_block(stage, torch.cat([d, L.nchw(skip)], dim=1),
                       "leaky_relu")
    out = dec.final(torch.cat([d, L.nchw(skips[0])], dim=1))
    return L.nhwc(OLD_ACT[dec.final_act](out))


def _old_dcgan_hoisted(dec, vec, skip_pre):
    d = _old_block(dec.head, vec[:, :, None, None], "leaky_relu")
    weights = dec._weights()
    for (w, b), pre in zip(weights[:-1], skip_pre[:-1]):
        y = F.conv_transpose2d(d, w[:d.shape[1]], None, 2, 1)
        d = L.leaky_relu(y + L.nchw(pre) + b[:, None, None])
    w, b = weights[-1]
    y = F.conv_transpose2d(d, w[:d.shape[1]], None, 2, 1)
    return L.nhwc(OLD_ACT[dec.final_act](y + L.nchw(skip_pre[-1])
                                         + b[:, None, None]))


BACKBONES = {"vgg128": (vgg, 128, _old_vgg_encode, _old_vgg_decode,
                        _old_vgg_hoisted),
             "dcgan64": (dcgan, 64, _old_dcgan_encode, _old_dcgan_decode,
                         _old_dcgan_hoisted)}
DIM, NC, BATCH = 16, 3, 2


@torch.no_grad()
def _folded(module, seed):
    """`module` with the init law's weights, then non-trivial BN
    statistics, affines and conv biases, folded."""
    g = torch.Generator().manual_seed(seed)
    L.init_weights(module, g)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_var.uniform_(0.5, 1.5, generator=g)
            for t in (m.running_mean, m.weight, m.bias):
                t.add_(0.1 * torch.randn(t.shape, generator=g))
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            # He's gain instead of the init's std 0.02, so that the maps
            # keep their scale through the depth
            i = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            fan_in = i / (m.stride[0] * m.stride[1]) if isinstance(
                m, torch.nn.ConvTranspose2d) else i
            m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
            m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=g))
    module.fold_()
    return module.eval()


@pytest.fixture(scope="module")
def nets():
    out = {}
    for name, (mod, width, *_) in BACKBONES.items():
        enc = _folded(mod.Encoder(DIM, NC, width), 1)
        dec = _folded(mod.Decoder(DIM, NC, width), 2)
        x = torch.rand((BATCH, width, width, NC),
                       generator=torch.Generator().manual_seed(3))
        out[name] = (enc, dec, x)
    return out


def _run(entry, net, enc, dec, x, old):
    """The encode's (h, *skips), or a decode's frames, by the wiring or (old)
    by the composition. Both decodes start from the composition's encode,
    so that they differ only in the decoder."""
    _, _, old_enc, old_dec, old_hoisted = BACKBONES[net]
    if entry == "encode":
        h, skips = old_enc(enc, x) if old else enc(x)
        return [h] + skips
    h, skips = old_enc(enc, x)
    if entry == "decode":
        return [old_dec(dec, h, skips) if old else dec(h, skips)]
    pre = dec.skip_pre(skips)
    return [old_hoisted(dec, h, pre) if old else dec.hoisted(h, pre)]


@pytest.mark.parametrize("net,entry,dtype", list(itertools.product(
    BACKBONES, ("encode", "decode", "hoisted"),
    (torch.float32, torch.bfloat16))))
@torch.no_grad()
def test_folded_backbone_against_the_composition(nets, net, entry, dtype):
    """f32: the same outputs up to the order of the conv's bias add (its
    own sum, or the epilogue's); measured ≤ 5.3e-6. bf16: the roundings
    move. On the CPU the conv added its bias before its one rounding, the
    epilogue adds it after the conv's (on the card cuDNN's bias add and the
    activation each rounded again); the hoisted decode's skip add rounds
    once instead of three times. So each map may drift from the f32 one by
    up to half again the composition's RMS drift (measured ≤ 1.26×, ≤ 0.89×
    in the hoisted decodes), and the two bf16 paths differ by under 2⁻⁴ of
    the map's RMS (measured ≤ 3%)."""
    enc, dec, x = nets[net]
    ref32 = _run(entry, net, enc, dec, x, True)
    # cast copies: a bf16 round trip of the shared modules would round the
    # folded up halves (sums of weights) apart from the weights they sum
    enc_t, dec_t = (copy.deepcopy(m).to(dtype) for m in (enc, dec))
    got = _run(entry, net, enc_t, dec_t, x.to(dtype), False)
    before = _run(entry, net, enc_t, dec_t, x.to(dtype), True)
    assert len(got) == len(before)

    def rms(t):
        return t.float().pow(2).mean().sqrt().item()

    for a, b, r in zip(got, before, ref32):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            continue
        a, b = a.float(), b.float()
        assert rms(a - r) <= 1.5 * rms(b - r), (rms(a - r), rms(b - r))
        assert rms(a - b) <= 2.0 ** -4 * rms(r), (rms(a - b), rms(r))


# -- what the wrapper refuses, counts and exports ----------------------------

@pytest.mark.parametrize("case", ["layout", "pre_strides", "act", "bias"])
def test_wrapper_refuses(case):
    y, bias, pre = _inputs("channels_last", torch.float32, True)
    args = {"layout": (y.transpose(2, 3), bias, None, "none"),
            "pre_strides": (y, bias, pre.contiguous(), "none"),
            "act": (y, bias, pre, "relu"),
            "bias": (y, bias[:-1], pre, "none")}[case]
    match = {"layout": "neither channels_last nor contiguous NCHW",
             "pre_strides": "pre's strides", "act": "act must be one of",
             "bias": "does not match"}[case]
    with pytest.raises(ValueError, match=match):
        conv_epilogue(*args)


def test_cpu_path_does_not_count_launches():
    before = conv_epilogue.launches
    conv_epilogue(*_inputs("channels_last", torch.bfloat16, True),
                  "leaky_relu")
    assert conv_epilogue.launches == before


def test_folded_block_exports_with_the_op():
    block = L.fold_conv_bn(L.conv_block(4, 8, 3, 1, 1).eval())

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block = block

        def forward(self, x):
            return self.block(x, "leaky_relu")

    x = torch.rand(2, 4, 6, 6).to(memory_format=torch.channels_last)
    program = torch.export.export(Block(), (x,))
    targets = [str(n.target) for n in program.graph.nodes]
    assert "dvg_tpu_torch.conv_epilogue.default" in targets
    torch.testing.assert_close(program.module()(x), Block()(x))


def test_kernel_name_is_in_the_elementwise_group():
    """The kernels' symbols (the epilogue and its pooled form), read from
    their source, fall in the frozen KERNEL_GROUPS' elementwise group, so
    `elementwise_ms_per_call.eval` keeps counting the work, and the
    engagement reader counts both."""
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", SOURCE.read_text())
    assert names == ["dvg_elementwise_epilogue",
                     "dvg_elementwise_epilogue_pool"]
    traced = [f"void (anonymous namespace)::{name}<__nv_bfloat16, 1, "
              "true, true>(__nv_bfloat16 const*, long long, int, int)"
              for name in names]
    for name in traced:
        assert group_of(name, KERNEL_GROUPS) == ELEMENTWISE
    read = reader("epilogue_launches_per_call.eval")
    spans = [("bench.window", 0.0, 100.0)]
    kernels = [(traced[i % 2], 10.0 * i, 10.0 * i + 5) for i in range(6)]
    assert read(Trace(kernels + [("sm90_fprop", 1.0, 2.0)], [], spans, [],
                      2), {}) == 3.0
    assert read(Trace([("sm90_fprop", 1.0, 2.0)], [], spans, [], 2),
                {}) is None
