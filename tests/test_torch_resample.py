"""The VGG eval step without resampling ops, on the CPU:

  * the fold of a nearest ×2 upsample and a 3×3 conv into one stride-2
    transposed conv (`vgg.fold_upsample`), in f64 at every decoder group
    shape of VGG-64 and VGG-128, against the upsample and the conv;
  * K3's pooled form (`ops.epilogue.conv_epilogue_pool`, its plain version
    here) bitwise against max_pool2d of the plain epilogue, in bf16 and
    f32, every activation, with NaN, signed zeros and odd sizes; what it
    refuses, counts and exports;
  * a folded VGG encode without skips: h bitwise that of the encode with
    them, and a folded decoder's fused decode equal to its hoisted one.

The pooled kernel against its plain version on the card:
tests/test_torch_cuda.py. The folded decodes against `dvg_tpu`:
tests/test_torch_backbones.py.
"""

import itertools

import pytest
import torch
import torch.nn.functional as F

from dvg_tpu_torch.models import layers as L
from dvg_tpu_torch.models import vgg
from dvg_tpu_torch.ops import epilogue as E

DIM, NC, BATCH = 16, 3, 2
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _bits(t):
    return t.contiguous().view(BITS[t.dtype])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker of the multi-worker suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the fold -----------------------------------------------------------------

def _group_shapes(width):
    """(c_u, c_out, side of the map before the upsample) of every decoder
    group's first conv: the head gives 4×4, each group doubles it."""
    return [(chain[0] // 2, chain[1], 4 * 2 ** i)
            for i, chain in enumerate(vgg.dec_groups(width))]


@pytest.mark.parametrize("width,group", [
    (w, i) for w in (64, 128) for i in range(len(vgg.dec_groups(w)))])
def test_fold_equals_upsample_then_conv_in_f64(width, group):
    c_u, c_out, side = _group_shapes(width)[group]
    g = torch.Generator().manual_seed(10 * width + group)
    w = torch.randn((c_out, c_u, 3, 3), generator=g, dtype=torch.float64)
    w *= (2.0 / (9 * c_u)) ** 0.5
    d = torch.randn((BATCH, c_u, side, side), generator=g,
                    dtype=torch.float64)
    want = F.conv2d(L.upsample_nearest2d(d), w, None, 1, 1)
    got = F.conv_transpose2d(d, vgg.fold_upsample(w), None, 2, 1)
    assert got.shape == want.shape == (BATCH, c_out, 2 * side, 2 * side)
    assert (got - want).abs().max().item() <= 1e-12


def test_fold_taps_by_phase():
    """w'[0] = w2, w'[1] = w1 + w2, w'[2] = w0 + w1, w'[3] = w0 per axis, in
    the (in, out, 4, 4) layout of a transposed conv's weight."""
    w = torch.arange(2 * 3 * 9, dtype=torch.float64).reshape(2, 3, 3, 3)
    f = vgg.fold_upsample(w)
    assert f.shape == (3, 2, 4, 4)
    rows = [w[..., 2, :], w[..., 1, :] + w[..., 2, :],
            w[..., 0, :] + w[..., 1, :], w[..., 0, :]]
    for p, r in enumerate(rows):
        cols = [r[..., 2], r[..., 1] + r[..., 2], r[..., 0] + r[..., 1],
                r[..., 0]]
        for q, c in enumerate(cols):
            assert torch.equal(f[:, :, p, q], c.transpose(0, 1))


# -- K3's pooled form ----------------------------------------------------------

def _pool_inputs(dtype, shape=(3, 16, 9, 7), seed=0):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(shape, generator=g).to(dtype)
    y[0, 0, 0, 0] = float("nan")              # a NaN in a window
    y[1, :, 2:4, 2:4] = 0.0                   # -0 and +0 in one window
    y[1, :, 2, 3] = -0.0
    bias = torch.randn(shape[1], generator=g).to(dtype)
    bias[:4] = 0.0
    return y.contiguous(memory_format=torch.channels_last), bias


@pytest.mark.parametrize("act,dtype", list(itertools.product(
    E.ACTS, (torch.float32, torch.bfloat16))))
def test_pooled_plain_version_is_maxpool_of_the_epilogue(act, dtype):
    y, bias = _pool_inputs(dtype)
    got = E.conv_epilogue_pool(y, bias, act)
    want = F.max_pool2d(E.conv_epilogue_plain(y, bias, None, act), 2, 2)
    assert got.dtype == dtype and got.shape == want.shape == (3, 16, 4, 3)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(got), _bits(want))
    assert got.isnan().any()


@pytest.mark.parametrize("case", ["layout", "act", "bias"])
def test_pooled_op_refuses(case):
    y, bias = _pool_inputs(torch.float32)
    args = {"layout": (y.contiguous(), bias, "none"),
            "act": (y, bias, "relu"), "bias": (y, bias[:-1], "none")}[case]
    match = {"layout": "channels_last", "act": "act must be one of",
             "bias": "does not match"}[case]
    with pytest.raises(ValueError, match=match):
        E.conv_epilogue_pool(*args)


def test_pooled_cpu_path_counts_no_launch_and_exports():
    y, bias = _pool_inputs(torch.bfloat16)
    before = (E.conv_epilogue.launches, E.conv_epilogue_pool.launches)
    E.conv_epilogue_pool(y, bias, "leaky_relu")
    assert (E.conv_epilogue.launches, E.conv_epilogue_pool.launches) == before
    block = L.fold_conv_bn(L.conv_block(4, 8, 3, 1, 1).eval())

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block = block

        def forward(self, x):
            return self.block.pooled(x, "leaky_relu")

    x = torch.rand(2, 4, 6, 6).to(memory_format=torch.channels_last)
    program = torch.export.export(Block(), (x,))
    targets = [str(n.target) for n in program.graph.nodes]
    assert "dvg_tpu_torch.conv_epilogue_pool.default" in targets
    assert torch.equal(program.module()(x), Block()(x))
    assert torch.equal(Block()(x), L.max_pool2d(block(x, "leaky_relu")))


# -- the folded VGG backbone ---------------------------------------------------

@torch.no_grad()
def _folded(module, seed):
    """`module` with He-gain weights, non-trivial BN statistics and biases,
    folded."""
    g = torch.Generator().manual_seed(seed)
    L.init_weights(module, g)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_var.uniform_(0.5, 1.5, generator=g)
            m.running_mean.add_(0.1 * torch.randn(m.num_features,
                                                  generator=g))
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
            m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=g))
    module.fold_()
    return module.eval()


@pytest.mark.parametrize("width,dtype", list(itertools.product(
    (64, 128), (torch.float32, torch.bfloat16))))
@torch.no_grad()
def test_encode_without_skips_gives_the_same_h(width, dtype):
    enc = _folded(vgg.Encoder(DIM, NC, width), 1).to(
        dtype=dtype, memory_format=torch.channels_last)
    x = torch.rand((BATCH, width, width, NC),
                   generator=torch.Generator().manual_seed(2)).to(dtype)
    h, skips = enc(x)
    h_bare, none = enc(x, skips=False)
    assert none is None and len(skips) == len(enc.groups)
    assert torch.equal(_bits(h_bare), _bits(h))


@pytest.mark.parametrize("width", [64, 128])
@torch.no_grad()
def test_folded_fused_decode_is_the_hoisted_split(width):
    enc = _folded(vgg.Encoder(DIM, NC, width), 1)
    dec = _folded(vgg.Decoder(DIM, NC, width), 3)
    assert len(dec.up) == len(dec.groups)
    for up, group in zip(dec.up, dec.groups):
        c = group[0].conv
        assert up.weight.shape == (c.in_channels // 2, c.out_channels, 4, 4)
    x = torch.rand((BATCH, width, width, NC),
                   generator=torch.Generator().manual_seed(4))
    h, skips = enc(x)
    assert torch.equal(dec(h, skips), dec.hoisted(h, dec.skip_pre(skips)))
