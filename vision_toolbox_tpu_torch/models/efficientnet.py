"""EfficientNet B0–B7 — port of ``vision_toolbox_tpu/models/efficientnet.py``.

B0's stage table scaled by the compound rule: widths ×``width_mult``
rounded to multiples of 8 (``make_divisible``), block counts
⌈n·``depth_mult``⌉. A 3×3/2 stem, the MBConv stages (SiLU, SE of a quarter
of the block input's width with SiLU and a sigmoid gate), a 1×1
``last_conv``. Each MBConv's stride-1 depthwise conv is a K9 conv on the
card (12 a forward in efficientnet_b0). Drop-path rises as 0.2·i/total
over the blocks and draws from the ``generator`` passed to the forward.

``get_feature_maps`` returns the detection taps: the expansion conv's
output of every strided MBConv, then ``last_conv``'s. Images and maps are
NHWC. Parameters are float32, drawn on the CPU from an explicit
``torch.Generator`` (seed 0 when none is given) and moved to ``device``,
the card unless the caller asks for another; ``dtype`` is the compute type.
Module names follow the JAX tree (``stem``, ``last_conv``); its
``stage_<i>_block_<j>`` are ``stages.<i>.<j>`` here.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import Tensor, nn

from ..nn.layers import ConvNormAct
from .base import Backbone, register_model, to_device
from .mbconv import MBConv, make_divisible

# B0 stage table: (expand ratio, kernel, stride, out channels, blocks)
_B0_STAGES = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)

# (width_mult, depth_mult)
_SCALING = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}
_NORM = dict(norm_eps=1e-3, norm_momentum=0.99)


class EfficientNet(Backbone):
    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 stochastic_depth: float = 0.2, *, dtype: torch.dtype | None = None,
                 device: torch.device | str = "cuda", generator: torch.Generator | None = None):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        kw = dict(dtype=dtype, generator=gen)
        self.compute_dtype = torch.float32 if dtype is None else dtype
        self.width_mult, self.depth_mult = width_mult, depth_mult
        stages = self._stages()
        total = sum(n for *_rest, n in stages)
        in_ch = make_divisible(32 * width_mult)
        self.stem = ConvNormAct(3, in_ch, 3, 2, act="silu", **_NORM, **kw)
        self.stages, block_idx = nn.ModuleList(), 0
        for expand, k, s, ch, n in stages:
            blocks = nn.ModuleList()
            for j in range(n):
                blocks.append(MBConv(
                    in_ch, in_ch * expand, ch, k, s if j == 0 else 1,
                    se_channels=max(1, in_ch // 4), se_act="silu", se_gate="sigmoid",
                    act="silu", stochastic_depth=stochastic_depth * block_idx / total, **kw))
                in_ch, block_idx = ch, block_idx + 1
            self.stages.append(blocks)
        self.last_conv = ConvNormAct(in_ch, self._last_channels(), 1, act="silu", **_NORM, **kw)
        to_device(self, device)

    def _stages(self) -> list[tuple[int, int, int, int, int]]:
        return [(expand, k, s, make_divisible(ch * self.width_mult),
                 int(math.ceil(n * self.depth_mult))) for expand, k, s, ch, n in _B0_STAGES]

    def _last_channels(self) -> int:
        return make_divisible(1280 * self.width_mult) if self.width_mult > 1.0 else 1280

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        taps, in_ch = [], make_divisible(32 * self.width_mult)
        for expand, _k, s, ch, _n in self._stages():
            if s == 2:
                taps.append(in_ch * expand if expand != 1 else in_ch)
            in_ch = ch
        return tuple(taps) + (self._last_channels(),)

    @property
    def stride(self) -> int:
        return 32

    def get_feature_maps(self, x: Tensor, train: bool = False, *, plain: bool = False,
                         generator: torch.Generator | None = None) -> list[Tensor]:
        """x: (B, H, W, 3) NHWC → the strided blocks' expansion outputs and
        the last conv's; ``plain`` runs K9's plain versions."""
        x = self.stem(x, train)
        outputs = []
        for blocks in self.stages:
            for block in blocks:
                if block.stride == 2:
                    x, expanded = block(x, train, True, plain=plain, generator=generator)
                    outputs.append(expanded)
                else:
                    x = block(x, train, plain=plain, generator=generator)
        outputs.append(self.last_conv(x, train))
        return outputs

    def forward(self, x: Tensor, train: bool = False, generator: torch.Generator | None = None,
                *, plain: bool = False) -> Tensor:
        """The last conv's (B, H/32, W/32, C) map."""
        return self.get_feature_maps(x, train, plain=plain, generator=generator)[-1]


def efficientnet_from_config(variant: str, **kwargs: Any) -> EfficientNet:
    w, d = _SCALING[variant]
    return EfficientNet(width_mult=w, depth_mult=d, **kwargs)


for _v in _SCALING:
    register_model(f"efficientnet_{_v}")(
        lambda variant=_v, **kw: efficientnet_from_config(variant, **kw))
