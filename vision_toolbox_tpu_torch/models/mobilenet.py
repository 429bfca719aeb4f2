"""MobileNetV3 large and small — port of
``vision_toolbox_tpu/models/mobilenet.py``.

A 3×3/2 hardswish stem of 16 channels, the MBConv blocks of the paper's
Tables 1 and 2 (SE of ``make_divisible(expanded / 4)`` with relu and the
hard-sigmoid gate), a 1×1 hardswish ``last_conv``. Each block's stride-1
depthwise conv is a K9 conv on the card (11 a forward in
mobilenet_v3_large). ``get_feature_maps`` returns the detection taps: the
expansion conv's output of every strided block, then ``last_conv``'s.
Images and maps are NHWC. Parameters are float32, drawn on the CPU from an
explicit ``torch.Generator`` (seed 0 when none is given) and moved to
``device``, the card unless the caller asks for another; ``dtype`` is the
compute type. Module names follow the JAX tree (``stem``, ``last_conv``);
its ``block_<i>`` are ``blocks.<i>`` here.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor, nn

from ..nn.layers import ConvNormAct
from .base import Backbone, register_model, to_device
from .mbconv import MBConv, make_divisible

# (kernel, expanded, out, use_se, act, stride) — MobileNetV3 paper Tables 1/2
LARGE = (
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
)
SMALL = (
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
)
_NORM = dict(norm_eps=1e-3, norm_momentum=0.99)


class MobileNetV3(Backbone):
    def __init__(self, config: tuple = LARGE, last_channels: int = 960, *,
                 dtype: torch.dtype | None = None, device: torch.device | str = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        kw = dict(dtype=dtype, generator=gen)
        self.compute_dtype = torch.float32 if dtype is None else dtype
        self.config, self.last_channels = tuple(tuple(c) for c in config), last_channels
        self.stem = ConvNormAct(3, 16, 3, 2, act="hardswish", **_NORM, **kw)
        in_ch, self.blocks = 16, nn.ModuleList()
        for k, exp, out, se, act, stride in self.config:
            self.blocks.append(MBConv(in_ch, exp, out, k, stride,
                                      se_channels=make_divisible(exp // 4) if se else None,
                                      se_act="relu", se_gate="hardsigmoid", act=act, **kw))
            in_ch = out
        self.last_conv = ConvNormAct(in_ch, last_channels, 1, act="hardswish", **_NORM, **kw)
        to_device(self, device)

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        return tuple(cfg[1] for cfg in self.config if cfg[5] == 2) + (self.last_channels,)

    @property
    def stride(self) -> int:
        return 32

    def get_feature_maps(self, x: Tensor, train: bool = False, *,
                         plain: bool = False) -> list[Tensor]:
        """x: (B, H, W, 3) NHWC → the strided blocks' expansion outputs and
        the last conv's; ``plain`` runs K9's plain versions."""
        x = self.stem(x, train)
        outputs = []
        for block in self.blocks:
            if block.stride == 2:
                x, expanded = block(x, train, True, plain=plain)
                outputs.append(expanded)
            else:
                x = block(x, train, plain=plain)
        outputs.append(self.last_conv(x, train))
        return outputs

    def forward(self, x: Tensor, train: bool = False, generator: torch.Generator | None = None,
                *, plain: bool = False) -> Tensor:
        """The last conv's (B, H/32, W/32, C) map (no random draw: the
        blocks have no drop-path)."""
        return self.get_feature_maps(x, train, plain=plain)[-1]


def mobilenet_from_config(variant: str, **kwargs: Any) -> MobileNetV3:
    if variant == "large":
        return MobileNetV3(LARGE, 960, **kwargs)
    return MobileNetV3(SMALL, 576, **kwargs)


register_model("mobilenet_v3_large")(lambda **kw: mobilenet_from_config("large", **kw))
register_model("mobilenet_v3_small")(lambda **kw: mobilenet_from_config("small", **kw))
