"""DCGAN-64 and DCGAN-128 encoder and decoder (counterpart of
`dvg_tpu/models/dcgan.py`).

  * encoder: four (64 px) or five (128 px) stride-2 4×4
    conv+BN+LeakyReLU(0.2) stages halving the resolution, then a 4×4 valid
    conv+BN+tanh head (4×4 → 1×1 → g_dim); the stage outputs are the U-Net
    skips.
  * decoder: a transposed-conv head 1×1 → 4×4, then stride-2 4×4 upconv
    stages each consuming cat([d, skip]), and a final transposed conv with
    tanh at 64 px and sigmoid at 128 px (the reference's quirk, kept on
    purpose: dcgan_64.py:76, dcgan_128.py:81).

Every function here takes and returns NHWC tensors; inside, the convs run
on NCHW-shaped channels_last views of the same memory.

The eval forward runs on the BN-folded model only (`fold_`, reached through
`DVGModel.fold_inference_params()` or the rollouts' `prepare()`), each conv
ending in one epilogue pass (`layers.conv_act`, `layers.skip_epilogue`).

Train mode (`Encoder.train_forward`, `Decoder.grouped`) normalizes by the
batch statistics of each call of a leading call axis and returns them, in
at least f32, for the running-statistics fold of `train/step.py`, in the
order of `bn_blocks()`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dvg_tpu_torch.models import layers as L
from dvg_tpu_torch.ops.epilogue import activate

NF = 64


def stage_channels(image_width: int, nc: int) -> List[Tuple[int, int]]:
    """The encoder stages' (in, out) channels (dcgan_64.py, dcgan_128.py)."""
    if image_width == 64:
        return [(nc, NF), (NF, NF * 2), (NF * 2, NF * 4), (NF * 4, NF * 8)]
    if image_width == 128:
        return [(nc, NF), (NF, NF * 2), (NF * 2, NF * 4), (NF * 4, NF * 8),
                (NF * 8, NF * 8)]
    raise ValueError(
        f"dcgan backbone supports image_width 64|128, got {image_width}")


def decoder_stage_channels(image_width: int) -> List[Tuple[int, int]]:
    """The decoder stages' (in, out) channels, the input doubled by the skip
    concat (upc2.. of dcgan_64.py:68-72, dcgan_128.py:64-72)."""
    if image_width == 64:
        return [(NF * 8 * 2, NF * 4), (NF * 4 * 2, NF * 2), (NF * 2 * 2, NF)]
    if image_width == 128:
        return [(NF * 8 * 2, NF * 8), (NF * 8 * 2, NF * 4),
                (NF * 4 * 2, NF * 2), (NF * 2 * 2, NF)]
    raise ValueError(
        f"dcgan backbone supports image_width 64|128, got {image_width}")


def final_activation(image_width: int) -> str:
    """The final transposed conv's activation, as its key in
    `ops.epilogue.ACTS`: the train decode applies it with
    `ops.epilogue.activate`, the eval decodes' epilogue takes it."""
    return "tanh" if image_width == 64 else "sigmoid"


class Encoder(nn.Module):
    def __init__(self, dim: int, nc: int, image_width: int = 64):
        super().__init__()
        chans = stage_channels(image_width, nc)
        self.stages = nn.ModuleList(L.conv_block(ci, co, 4, 2, 1)
                                    for ci, co in chans)
        self.head = L.conv_block(chans[-1][1], dim, 4, 1, 0)

    def forward(self, x: torch.Tensor, skips: bool = True
                ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        """x (B, H, W, C) → (h (B, dim), skips: per-stage NHWC maps, None
        where `skips` is False: every stage's map feeds the next, so the
        work is the same)."""
        h = L.nchw(x)
        maps = []
        for stage in self.stages:
            h = stage(h, "leaky_relu")
            maps.append(L.nhwc(h))
        h = self.head(h, "tanh")
        return h.reshape(h.shape[0], -1), maps if skips else None

    def train_forward(self, x: torch.Tensor, calls: int,
                      dtype: Optional[torch.dtype] = None, group=None
                      ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                 List[L.BNStats]]:
        """Train-mode encode of x (calls·B, H, W, C), `calls` frames of B
        each normalized by its own batch statistics (global over `group`'s
        ranks under one), in one conv pass per block with every weight cast
        to `dtype` → (h (calls·B, dim), skips, per-block statistics (calls,
        C), stages then head)."""
        h = L.nchw(L.cast(x, dtype))
        skips, stats = [], []
        for stage in self.stages:
            h, st = stage.train_forward(h, calls, "leaky_relu", dtype, group)
            skips.append(L.nhwc(h))
            stats.append(st)
        h, st = self.head.train_forward(h, calls, "tanh", dtype, group)
        stats.append(st)
        return h.reshape(h.shape[0], -1), skips, stats

    def bn_blocks(self) -> List[L.ConvBlock]:
        """The BN blocks in the order of `train_forward`'s statistics."""
        return list(self.stages) + [self.head]

    def fold_(self) -> None:
        """Fold every eval-mode BN into its conv, in place."""
        self.stages = nn.ModuleList(L.fold_conv_bn(s) for s in self.stages)
        self.head = L.fold_conv_bn(self.head)


class Decoder(nn.Module):
    def __init__(self, dim: int, nc: int, image_width: int = 64):
        super().__init__()
        self.head = L.upconv_block(dim, NF * 8, 4, 1, 0)
        self.stages = nn.ModuleList(
            L.upconv_block(ci, co, 4, 2, 1)
            for ci, co in decoder_stage_channels(image_width))
        self.final = nn.ConvTranspose2d(NF * 2, nc, 4, 2, 1)
        self.final_act = final_activation(image_width)

    def forward(self, vec: torch.Tensor, skips: List[torch.Tensor]
                ) -> torch.Tensor:
        """Fused eval decode: (vec (B, dim), encoder skips) → (B, H, W, nc)."""
        d = self.head(vec[:, :, None, None], "leaky_relu")
        for stage, skip in zip(self.stages, reversed(skips)):
            d = stage(torch.cat([d, L.nchw(skip)], dim=1), "leaky_relu")
        return L.nhwc(L.conv_act(
            self.final, torch.cat([d, L.nchw(skips[0])], dim=1),
            self.final_act))

    def bn_blocks(self) -> List[L.ConvBlock]:
        """The BN blocks in the order of `grouped`'s statistics."""
        return [self.head] + list(self.stages)

    def fold_(self) -> None:
        """Fold every eval-mode BN into its conv, in place (the final
        transposed conv has no BN)."""
        self.head = L.fold_conv_bn(self.head)
        self.stages = nn.ModuleList(L.fold_conv_bn(s) for s in self.stages)

    def grouped(self, vecs: torch.Tensor, skips_u: List[torch.Tensor],
                group_idx: torch.Tensor, dtype: Optional[torch.dtype] = None,
                group=None) -> Tuple[torch.Tensor, List[L.BNStats]]:
        """Train-mode decode of N latent calls whose skips come from a few
        unique frames (`dvg_tpu`'s decoder_apply_grouped): vecs (N, B, dim),
        skips_u per encoder stage (U, B, h, w, c), group_idx (N,) int64 —
        call n reads the skips of unique frame group_idx[n].

        Every stage's transposed conv splits by linearity over the channel
        concat, convT(cat(d, s), W) = convT(d, W[:c_d]) + convT(s, W[c_d:]),
        so the skip half runs once per unique frame (U·B) and reaches its
        calls through an index_select (whose backward is an index_add).
        Each call's BN uses its own batch statistics (global over `group`'s
        ranks under one). In bf16 each half rounds to bf16 before the sum,
        as in the JAX package. → (frames (N, B, H, W, nc), per-call
        statistics (N, C) of the head and each stage)."""
        n, b = vecs.shape[0], vecs.shape[1]

        def split_conv_t(conv: nn.Module, d: torch.Tensor,
                         sk: torch.Tensor) -> torch.Tensor:
            w = L.cast(conv.weight, dtype)
            c_d = d.shape[1]
            s_out = L.nhwc(F.conv_transpose2d(
                L.nchw(L.cast(sk, dtype).flatten(0, 1)), w[c_d:], None, 2, 1))
            s_b = s_out.unflatten(0, sk.shape[:2]).index_select(0, group_idx)
            return (F.conv_transpose2d(d, w[:c_d], None, 2, 1)
                    + L.nchw(s_b.flatten(0, 1))
                    + L.cast(conv.bias, dtype)[:, None, None])

        d = L.cast(vecs, dtype).reshape(n * b, -1, 1, 1)
        d, st = self.head.train_forward(d, n, "leaky_relu", dtype, group)
        stats = [st]
        for stage, sk in zip(self.stages, reversed(skips_u)):
            d, st = L.batch_norm_act(
                split_conv_t(stage.conv, d, sk), L.cast(stage.bn.weight, dtype),
                L.cast(stage.bn.bias, dtype), n, "leaky_relu", group)
            stats.append(st)
        y = split_conv_t(self.final, d, skips_u[0])
        y = activate(y, self.final_act)
        return L.nhwc(y).unflatten(0, (n, b)), stats

    def _weights(self):
        """(weight, bias) of every stage after the head, then the final —
        one per skip, deepest skip first."""
        return ([(s.conv.weight, s.conv.bias) for s in self.stages]
                + [(self.final.weight, self.final.bias)])

    def skip_pre(self, skips: List[torch.Tensor]) -> List[torch.Tensor]:
        """Skip-half transposed-conv contribution of every stage for a
        FROZEN skip set (the skips stay at the last context frame for the
        whole free run), computed once instead of at every step: by
        linearity convT(cat(d, s), W) = convT(d, W[:c_d]) + convT(s, W[c_d:]),
        input channels being dim 0 of a ConvTranspose2d weight. Entries
        follow `hoisted`'s stage order; each keeps the skips' batch."""
        outs = []
        for (w, _), skip in zip(self._weights(), reversed(skips)):
            c_s = skip.shape[-1]
            outs.append(L.nhwc(F.conv_transpose2d(
                L.nchw(skip), w[w.shape[0] - c_s:], None, 2, 1)))
        return outs

    def hoisted(self, vec: torch.Tensor, skip_pre: List[torch.Tensor]
                ) -> torch.Tensor:
        """Eval decode against `skip_pre`'s precomputed halves. Needs a
        BN-folded decoder (`fold_`) and each pre at vec's batch: the merged
        sample·batch caller tiles the pre ONCE before its loop. In bf16
        each half rounds to bf16 before the sum, as in the JAX package."""
        if skip_pre[0].shape[0] != vec.shape[0]:
            raise ValueError(
                f"hoisted decode: skip_pre batch {skip_pre[0].shape[0]} != "
                f"latent batch {vec.shape[0]}; tile the pre to the latent "
                "batch once, outside the loop")
        d = self.head(vec[:, :, None, None], "leaky_relu")
        acts = ["leaky_relu"] * len(self.stages) + [self.final_act]
        for (w, b), pre, act in zip(self._weights(), skip_pre, acts):
            y = F.conv_transpose2d(d, w[:d.shape[1]], None, 2, 1)
            d = L.skip_epilogue(y, b, pre, act)
        return L.nhwc(d)
