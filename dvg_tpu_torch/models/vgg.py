"""VGG-64 and VGG-128 encoder and decoder (counterpart of
`dvg_tpu/models/vgg.py`).

  * encoder: per-resolution groups of 3×3 conv+BN+LeakyReLU(0.2) blocks
    with a 2×2 max-pool between groups; a 4×4 valid conv+BN+tanh head
    collapses the last pooled 4×4 map to the g_dim vector. The skips are
    the PRE-pool group outputs, so skip 0 is at full resolution
    (vgg_64.py:51-56).
  * decoder: a transposed-conv head 1×1 → 4×4, then per group a nearest ×2
    upsample and the group's blocks on cat([up, skip]) (vgg_64.py:97-105);
    a final 3×3 same-size transposed conv and sigmoid.

Module names mirror the JAX package's tree (`groups.{i}.{j}`, `head`,
`final`), so `convert.py` maps one onto the other by name. Every function
here takes and returns NHWC tensors; inside, the convs run on NCHW-shaped
channels_last views of the same memory. Only each decoder group's FIRST
conv reads the skip concat, so only that conv splits by linearity in the
grouped train decode and the eval decodes.

The eval forward runs on the BN-folded model only (`fold_`, reached
through `DVGModel.fold_inference_params()` or the rollouts' `prepare()`),
and runs no resampling op of its own where it keeps no skips:
  * a nearest ×2 upsample followed by a 3×3 pad-1 conv is one stride-2,
    kernel-4, pad-1 transposed conv of the small map, its taps the 3×3
    taps summed per output phase (`fold_upsample`). `Decoder.fold_` builds
    it for every group's up half (`Decoder.up`), and both eval decodes run
    it instead of the upsample and the up half's conv: 4/9 of the FLOPs,
    and no upsampled map;
  * an encode that wants no skips (`Encoder.forward(x, skips=False)`, the
    rollouts' frozen-skip free run) ends every group's last conv in K3's
    pooled form (`layers.ConvBlock.pooled`), which writes the pooled map
    only; with skips, the full maps are kept and pooled by the stock op.
The train path (`Encoder.train_forward`, `Decoder.grouped`) keeps the
upsample and the max-pool.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dvg_tpu_torch.models import layers as L


def enc_groups(image_width: int, nc: int) -> List[List[int]]:
    """Per-group channel chains [in, out, out, …] (vgg_64.py:21-44)."""
    if image_width == 64:
        return [[nc, 64, 64], [64, 128, 128], [128, 256, 256, 256],
                [256, 512, 512, 512]]
    if image_width == 128:
        return [[nc, 64, 64], [64, 128, 128], [128, 256, 256, 256],
                [256, 512, 512, 512], [512, 512, 512, 512]]
    raise ValueError(
        f"vgg backbone supports image_width 64|128, got {image_width}")


def dec_groups(image_width: int) -> List[List[int]]:
    """Decoder group chains, the first input doubled by the skip concat
    (upc2.. of vgg_64.py:71-90, vgg_128.py:77-106)."""
    if image_width == 64:
        return [[512 * 2, 512, 512, 256], [256 * 2, 256, 256, 128],
                [128 * 2, 128, 64], [64 * 2, 64]]
    if image_width == 128:
        return [[512 * 2, 512, 512, 512], [512 * 2, 512, 512, 256],
                [256 * 2, 256, 256, 128], [128 * 2, 128, 64], [64 * 2, 64]]
    raise ValueError(
        f"vgg backbone supports image_width 64|128, got {image_width}")


def _group(chain: List[int]) -> nn.ModuleList:
    return nn.ModuleList(L.conv_block(ci, co, 3, 1, 1)
                         for ci, co in zip(chain[:-1], chain[1:]))


def _phase_taps(w: torch.Tensor, dim: int) -> torch.Tensor:
    """Along `dim`, the 3 taps of a conv after a nearest ×2 upsample as the
    4 taps of a stride-2 transposed conv: output 2m reads input m (tap 1)
    and m − 1 (tap 3), output 2m + 1 reads m + 1 (tap 0) and m (tap 2)."""
    w0, w1, w2 = w.unbind(dim)
    return torch.stack([w2, w1 + w2, w0 + w1, w0], dim)


def fold_upsample(w: torch.Tensor) -> torch.Tensor:
    """The weight (I, O, 4, 4) of the stride-2, pad-1 transposed conv equal
    to a nearest ×2 upsample followed by the 3×3, pad-1 conv of weight w
    (O, I, 3, 3): per axis w'[0] = w2, w'[1] = w1 + w2, w'[2] = w0 + w1,
    w'[3] = w0, with no flip. Summed in w's dtype, on w's device, with no
    host copy (it runs in every `prepare()`)."""
    return _phase_taps(_phase_taps(w, 2), 3).transpose(0, 1)


def _up_conv(first: nn.Conv2d) -> nn.ConvTranspose2d:
    """A decoder group's first conv's up half (its first half of input
    channels, the upsampled map's) folded with the upsample
    (`fold_upsample`), as a module without bias, so that `prepare()` casts
    and lays it out like every other weight."""
    w = first.weight[:, :first.in_channels // 2]
    up = nn.utils.skip_init(nn.ConvTranspose2d, w.shape[1], w.shape[0], 4,
                            2, 1, bias=False, device=w.device, dtype=w.dtype)
    with torch.no_grad():
        up.weight.copy_(fold_upsample(w))
    return up


def _fold_groups(groups: nn.ModuleList) -> nn.ModuleList:
    return nn.ModuleList(nn.ModuleList(L.fold_conv_bn(b) for b in g)
                         for g in groups)


def _blocks_eval(blocks, h: torch.Tensor) -> torch.Tensor:
    for block in blocks:
        h = block(h, "leaky_relu")
    return h


def _blocks_train(blocks, h: torch.Tensor, calls: int, dtype,
                  stats: List[L.BNStats], group=None) -> torch.Tensor:
    for block in blocks:
        y, st = block.train_forward(h, calls, dtype, group)
        h = L.leaky_relu(y)
        stats.append(st)
    return h


class Encoder(nn.Module):
    def __init__(self, dim: int, nc: int, image_width: int = 64):
        super().__init__()
        chains = enc_groups(image_width, nc)
        self.groups = nn.ModuleList(_group(c) for c in chains)
        self.head = L.conv_block(chains[-1][-1], dim, 4, 1, 0)

    def forward(self, x: torch.Tensor, skips: bool = True
                ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        """x (B, H, W, C) → (h (B, dim), skips: per-group NHWC maps). With
        `skips` False the skips are None and no group's full map is kept:
        each group's last block ends in the max-pool (`ConvBlock.pooled`,
        one K3 pass for a folded block); h is bitwise the same."""
        h = L.nchw(x)
        maps = []
        for group in self.groups:
            h = _blocks_eval(group[:-1], h)
            if skips:
                h = group[-1](h, "leaky_relu")
                maps.append(L.nhwc(h))
                h = L.max_pool2d(h)
            else:
                h = group[-1].pooled(h, "leaky_relu")
        h = self.head(h, "tanh")
        return h.reshape(h.shape[0], -1), maps if skips else None

    def train_forward(self, x: torch.Tensor, calls: int,
                      dtype: Optional[torch.dtype] = None, group=None
                      ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                 List[L.BNStats]]:
        """Train-mode encode of x (calls·B, H, W, C), each of the `calls`
        frames normalized by its own batch statistics (global over
        `group`'s ranks under one), every weight cast to `dtype` → (h
        (calls·B, dim), skips, per-block statistics (calls, C) in the order
        of `bn_blocks()`)."""
        h = L.nchw(L.cast(x, dtype))
        skips, stats = [], []
        for i, blocks in enumerate(self.groups):
            h = _blocks_train(blocks, L.max_pool2d(h) if i else h, calls,
                              dtype, stats, group)
            skips.append(L.nhwc(h))
        y, st = self.head.train_forward(L.max_pool2d(h), calls, dtype, group)
        stats.append(st)
        h = torch.tanh(y)
        return h.reshape(h.shape[0], -1), skips, stats

    def bn_blocks(self) -> List[L.ConvBlock]:
        """Every group's blocks in order, then the head."""
        return [b for g in self.groups for b in g] + [self.head]

    def fold_(self) -> None:
        """Fold every eval-mode BN into its conv, in place."""
        self.groups = _fold_groups(self.groups)
        self.head = L.fold_conv_bn(self.head)


class Decoder(nn.Module):
    def __init__(self, dim: int, nc: int, image_width: int = 64):
        super().__init__()
        self.head = L.upconv_block(dim, 512, 4, 1, 0)
        self.groups = nn.ModuleList(_group(c) for c in dec_groups(image_width))
        self.final = nn.ConvTranspose2d(64, nc, 3, 1, 1)
        # each group's folded up half (`fold_upsample`), set by `fold_`
        self.up: Optional[nn.ModuleList] = None

    def forward(self, vec: torch.Tensor, skips: List[torch.Tensor]
                ) -> torch.Tensor:
        """Fused eval decode: (vec (B, dim), encoder skips) → (B, H, W, nc),
        `hoisted`'s split with the skip halves computed on the call."""
        return self.hoisted(vec, self.skip_pre(skips))

    def bn_blocks(self) -> List[L.ConvBlock]:
        """The head, then every group's blocks in order."""
        return [self.head] + [b for g in self.groups for b in g]

    def fold_(self) -> None:
        """Fold every eval-mode BN into its conv, in place (the final
        transposed conv has no BN), then fold each group's up half and the
        upsample before it into a transposed conv (`up`), in f32. The
        group's first conv keeps its whole weight: its skip half and bias
        are read from it."""
        self.head = L.fold_conv_bn(self.head)
        self.groups = _fold_groups(self.groups)
        self.up = nn.ModuleList(_up_conv(g[0].conv) for g in self.groups)

    def grouped(self, vecs: torch.Tensor, skips_u: List[torch.Tensor],
                group_idx: torch.Tensor, dtype: Optional[torch.dtype] = None,
                group=None) -> Tuple[torch.Tensor, List[L.BNStats]]:
        """Train-mode decode of N latent calls whose skips come from a few
        unique frames (`dvg_tpu`'s vgg.decoder_apply_grouped; the contract
        of dcgan.Decoder.grouped): vecs (N, B, dim), skips_u per encoder
        group (U, B, h, w, c), group_idx (N,) int64.

        Each group's first conv splits by linearity over the concat,
        conv(cat(u, s), W) = conv(u, W[:, :c_u]) + conv(s, W[:, c_u:]), so
        its skip half runs once per unique frame and reaches the calls
        through an index_select; the group's later convs see only the
        previous block. Each call's BN uses its own batch statistics. →
        (frames (N, B, H, W, nc), per-call statistics (N, C) in the order
        of `bn_blocks()`)."""
        n, b = vecs.shape[0], vecs.shape[1]
        d = L.cast(vecs, dtype).reshape(n * b, -1, 1, 1)
        y, st = self.head.train_forward(d, n, dtype, group)
        d = L.leaky_relu(y)
        stats = [st]
        for blocks, sk in zip(self.groups, reversed(skips_u)):
            up = L.upsample_nearest2d(d)
            first = blocks[0]
            w = L.cast(first.conv.weight, dtype)
            c_u = up.shape[1]
            s_out = L.nhwc(F.conv2d(L.nchw(L.cast(sk, dtype).flatten(0, 1)),
                                    w[:, c_u:], None, 1, 1))
            s_b = s_out.unflatten(0, sk.shape[:2]).index_select(0, group_idx)
            y = (F.conv2d(up, w[:, :c_u], None, 1, 1)
                 + L.nchw(s_b.flatten(0, 1))
                 + L.cast(first.conv.bias, dtype)[:, None, None])
            y, st = L.batch_norm_train(y, L.cast(first.bn.weight, dtype),
                                       L.cast(first.bn.bias, dtype), n,
                                       group=group)
            d = L.leaky_relu(y)
            stats.append(st)
            d = _blocks_train(blocks[1:], d, n, dtype, stats, group)
        y = L.conv_apply(self.final, d, dtype)
        return L.nhwc(torch.sigmoid(y)).unflatten(0, (n, b)), stats

    def skip_pre(self, skips: List[torch.Tensor]) -> List[torch.Tensor]:
        """The skip half of every group's first conv for a FROZEN skip set,
        computed once instead of at every step (input channels are dim 1
        of a Conv2d weight). Entries follow the groups; each keeps the
        skips' batch."""
        outs = []
        for group, skip in zip(self.groups, reversed(skips)):
            w = group[0].conv.weight
            c_s = skip.shape[-1]
            outs.append(L.nhwc(F.conv2d(L.nchw(skip), w[:, w.shape[1] - c_s:],
                                        None, 1, 1)))
        return outs

    def hoisted(self, vec: torch.Tensor, skip_pre: List[torch.Tensor]
                ) -> torch.Tensor:
        """Eval decode against `skip_pre`'s precomputed halves, with the
        contract of dcgan.Decoder.hoisted: a BN-folded decoder, each pre at
        vec's batch; in bf16 each half rounds before the sum. Each group's
        up half is the folded transposed conv of the small map, its output
        handed to the epilogue with the bias and the pre."""
        if skip_pre[0].shape[0] != vec.shape[0]:
            raise ValueError(
                f"hoisted decode: skip_pre batch {skip_pre[0].shape[0]} != "
                f"latent batch {vec.shape[0]}; tile the pre to the latent "
                "batch once, outside the loop")
        d = self.head(vec[:, :, None, None], "leaky_relu")
        for group, up, pre in zip(self.groups, self.up, skip_pre):
            y = L.conv_apply(up, d, bias=False)
            d = _blocks_eval(group[1:], L.skip_epilogue(
                y, group[0].conv.bias, pre, "leaky_relu"))
        return L.nhwc(L.conv_act(self.final, d, "sigmoid"))


class GaussianEncoder(nn.Module):
    """The VGG encoder as the trunk of a Gaussian (VAE) head (reference
    vgg_64.py:108-159; `dvg_tpu`'s gaussian_encoder_*): mu and logvar
    Linears on the trunk's h, and the sample mu + exp(logvar / 2)·eps
    from an eps (B, output_size) the caller gives. The reference's scripts
    do not use it; it is off the card's path."""

    def __init__(self, dim: int, output_size: int, nc: int = 1,
                 image_width: int = 64):
        super().__init__()
        self.trunk = Encoder(dim, nc, image_width)
        self.mu = nn.Linear(dim, output_size)
        self.logvar = nn.Linear(dim, output_size)

    def _head(self, h: torch.Tensor, eps: torch.Tensor):
        mu, logvar = self.mu(h), self.logvar(h)
        return mu + torch.exp(0.5 * logvar) * eps, mu, logvar

    def forward(self, x: torch.Tensor, eps: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           List[torch.Tensor]]:
        """Eval mode, on the folded trunk (`fold_`): x (B, H, W, C) → (z,
        mu, logvar, skips)."""
        h, skips = self.trunk(x)
        return self._head(h, eps) + (skips,)

    def fold_(self) -> None:
        """Fold the trunk's eval-mode BNs into its convs, in place."""
        self.trunk.fold_()

    def train_forward(self, x: torch.Tensor, eps: torch.Tensor,
                      group=None):
        """Train mode (BN batch statistics, global over `group`'s ranks
        under one) → (z, mu, logvar, skips, per-block statistics)."""
        h, skips, stats = self.trunk.train_forward(x, 1, group=group)
        return self._head(h, eps) + (skips, stats)
