"""Backbone registry (counterpart of `dvg_tpu/models/registry.py`):
(model, image_width) → the encoder and decoder classes of one of the four
backbones, DCGAN-64, DCGAN-128, VGG-64 and VGG-128.

Every backbone's modules have the same interface: `Encoder(dim, nc)` with
`forward`, `train_forward`, `bn_blocks` and `fold_`; `Decoder(dim, nc)`
with `forward`, `grouped`, `skip_pre`, `hoisted`, `bn_blocks` and
`fold_`."""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

from torch import nn

from dvg_tpu_torch.models import dcgan, vgg


class Backbone(NamedTuple):
    encoder: Callable[[int, int], nn.Module]     # (dim, nc) → Encoder
    decoder: Callable[[int, int], nn.Module]     # (dim, nc) → Decoder


def get_backbone(model: str = "dcgan", image_width: int = 64) -> Backbone:
    if image_width not in (64, 128):
        raise ValueError(f"image_width must be 64 or 128, got {image_width}")
    mods = {"dcgan": dcgan, "vgg": vgg}
    if model not in mods:
        raise ValueError(f"model must be 'dcgan' or 'vgg', got {model!r}")
    mod = mods[model]
    return Backbone(
        encoder=functools.partial(mod.Encoder, image_width=image_width),
        decoder=functools.partial(mod.Decoder, image_width=image_width))
