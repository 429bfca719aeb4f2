"""RegNet X and Y — port of ``vision_toolbox_tpu/models/regnet.py``.

Stage widths and block counts from the RegNet design-space rule (a
quantized log-linear width per block, ``_generate_widths``), each width
rounded to its group width (``stage_config``); a 3×3/2 stem of 32
channels, then per stage ``RegNetBlock``s (1×1 → grouped 3×3 at the
stage's stride → Y: SE of a quarter of the block input's width → 1×1, with
a 1×1 ``downsample`` where the shape changes). No TPU kernel runs in the
model: cuDNN runs the convs, grouped ones too (XLA in the JAX package), the
port's ``BatchNorm`` their norms. ``get_feature_maps`` returns every
stage's output. Images and maps are NHWC. Parameters are float32, drawn on
the CPU from an explicit ``torch.Generator`` (seed 0 when none is given) and
moved to ``device``, the card unless the caller asks for another; ``dtype``
is the compute type. Module names follow the JAX tree (``stem``,
``conv1``–``conv3``, ``se``, ``downsample``); its ``stage_<i>_block_<j>``
are ``stages.<i>.<j>`` here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..nn.layers import ConvNormAct, SqueezeExcitation
from .base import Backbone, register_model, to_device


def _generate_widths(depth: int, w0: int, wa: float, wm: float) -> list[tuple[int, int]]:
    """[(width, blocks)] per stage from the RegNet design-space rule (numpy,
    as the JAX package computes it)."""
    ks = np.round(np.log((w0 + wa * np.arange(depth)) / w0) / np.log(wm))
    widths = (np.round(w0 * np.power(wm, ks) / 8) * 8).astype(int)
    stage_widths, counts = [], []
    for w in widths:
        if not stage_widths or stage_widths[-1] != w:
            stage_widths.append(int(w))
            counts.append(1)
        else:
            counts[-1] += 1
    return list(zip(stage_widths, counts))


def stage_config(depth: int, w0: int, wa: float, wm: float,
                 group_width: int) -> list[tuple[int, int, int]]:
    """[(width, blocks, group width)] per stage: each width rounded to a
    multiple of its group width, min(group_width, width)."""
    out = []
    for w, n in _generate_widths(depth, w0, wa, wm):
        g = min(group_width, w)
        out.append((int(round(w / g) * g), n, g))
    return out


class RegNetBlock(nn.Module):
    def __init__(self, in_channels: int, width: int, stride: int, group_width: int,
                 se_ratio: float | None = None, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        groups = max(1, width // group_width)
        self.conv1 = ConvNormAct(in_channels, width, 1, **kw)
        self.conv2 = ConvNormAct(width, width, 3, stride, groups=groups, **kw)
        self.se = (SqueezeExcitation(width, max(1, int(in_channels * se_ratio)), **kw)
                   if se_ratio else None)
        self.conv3 = ConvNormAct(width, width, 1, act="none", **kw)
        self.downsample = (ConvNormAct(in_channels, width, 1, stride, act="none", **kw)
                           if stride != 1 or in_channels != width else None)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = self.conv2(self.conv1(x, train), train)
        if self.se is not None:
            y = self.se(y)
        y = self.conv3(y, train)
        return F.relu(y + (x if self.downsample is None else self.downsample(x, train)))


class RegNet(Backbone):
    def __init__(self, depth: int, w0: int, wa: float, wm: float, group_width: int,
                 se_ratio: float | None = None, *, dtype: torch.dtype | None = None,
                 device: torch.device | str = "cuda", generator: torch.Generator | None = None):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        kw = dict(dtype=dtype, generator=gen)
        self.compute_dtype = torch.float32 if dtype is None else dtype
        self.stage_config = stage_config(depth, w0, wa, wm, group_width)
        self.stem = ConvNormAct(3, 32, 3, 2, **kw)
        in_ch, self.stages = 32, nn.ModuleList()
        for w, n, g in self.stage_config:
            blocks = nn.ModuleList()
            for j in range(n):
                blocks.append(RegNetBlock(in_ch, w, 2 if j == 0 else 1, g, se_ratio, **kw))
                in_ch = w
            self.stages.append(blocks)
        to_device(self, device)

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        return tuple(w for w, _n, _g in self.stage_config)

    @property
    def stride(self) -> int:
        return 2 * 2 ** len(self.stage_config)

    def get_feature_maps(self, x: Tensor, train: bool = False) -> list[Tensor]:
        """x: (B, H, W, 3) NHWC → every stage's NHWC output."""
        x = self.stem(x, train)
        outputs = []
        for blocks in self.stages:
            for block in blocks:
                x = block(x, train)
            outputs.append(x)
        return outputs


# torchvision's variant tables: (depth, w0, wa, wm, group_width)
_REGNET_X = {
    "regnet_x_400mf": (22, 24, 24.48, 2.54, 16),
    "regnet_x_800mf": (16, 56, 35.73, 2.28, 16),
    "regnet_x_1_6gf": (18, 80, 34.01, 2.25, 24),
    "regnet_x_3_2gf": (25, 88, 26.31, 2.25, 48),
    "regnet_x_8gf": (23, 80, 49.56, 2.88, 120),
    "regnet_x_16gf": (22, 216, 55.59, 2.1, 128),
    "regnet_x_32gf": (23, 320, 69.86, 2.0, 168),
}
_REGNET_Y = {
    "regnet_y_400mf": (16, 48, 27.89, 2.09, 8),
    "regnet_y_800mf": (14, 56, 38.84, 2.4, 16),
    "regnet_y_1_6gf": (27, 48, 20.71, 2.65, 24),
    "regnet_y_3_2gf": (21, 80, 42.63, 2.66, 24),
    "regnet_y_8gf": (17, 192, 76.82, 2.19, 56),
    "regnet_y_16gf": (18, 200, 106.23, 2.48, 112),
    "regnet_y_32gf": (20, 232, 115.89, 2.53, 232),
}


def regnet_from_config(variant: str, **kwargs: Any) -> RegNet:
    if variant in _REGNET_X:
        return RegNet(*_REGNET_X[variant], se_ratio=None, **kwargs)
    return RegNet(*_REGNET_Y[variant], se_ratio=0.25, **kwargs)


for _v in list(_REGNET_X) + list(_REGNET_Y):
    register_model(_v)(lambda variant=_v, **kw: regnet_from_config(variant, **kw))
