"""ResNet, ResNeXt and Wide-ResNet — port of
``vision_toolbox_tpu/models/resnet.py``.

A 7×7/2 stem and a 3×3/2 max pool (``max_pool_torch``), then four stages
of ``BasicBlock`` (resnet18/34) or ``Bottleneck`` (1×1 → 3×3 at the
stage's stride, grouped for ResNeXt, ``width_per_group`` wide → 1×1, 4×
expansion) with a 1×1 ``downsample`` projection where the shape changes.
No TPU kernel runs in the model: cuDNN runs the convs, grouped ones too
(XLA in the JAX package), the port's ``BatchNorm`` their norms.
``get_feature_maps`` returns the four stages' outputs (strides 4 to 32).
Images and maps are NHWC. Parameters are float32, drawn on the CPU from an
explicit ``torch.Generator`` (seed 0 when none is given) and moved to
``device``, the card unless the caller asks for another; ``dtype`` is the
compute type. Module names are the JAX tree's (``stem``,
``layer<i>_block<j>``, ``conv1``–``conv3``, ``downsample``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..nn.layers import ConvNormAct, max_pool_torch
from .base import Backbone, register_model, to_device


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = ConvNormAct(in_channels, out_channels, 3, stride, **kw)
        self.conv2 = ConvNormAct(out_channels, out_channels, 3, act="none", **kw)
        self.downsample = (ConvNormAct(in_channels, out_channels, 1, stride, act="none", **kw)
                           if stride != 1 or in_channels != out_channels else None)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = self.conv2(self.conv1(x, train), train)
        return F.relu(y + (x if self.downsample is None else self.downsample(x, train)))


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, groups: int = 1,
                 width_per_group: int = 64, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        """``out_channels`` is the expanded width, 4× the block's middle."""
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        width = int(out_channels // 4 * (width_per_group / 64.0)) * groups
        self.conv1 = ConvNormAct(in_channels, width, 1, **kw)
        self.conv2 = ConvNormAct(width, width, 3, stride, groups=groups, **kw)
        self.conv3 = ConvNormAct(width, out_channels, 1, act="none", **kw)
        self.downsample = (ConvNormAct(in_channels, out_channels, 1, stride, act="none", **kw)
                           if stride != 1 or in_channels != out_channels else None)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = self.conv3(self.conv2(self.conv1(x, train), train), train)
        return F.relu(y + (x if self.downsample is None else self.downsample(x, train)))


class ResNet(Backbone):
    def __init__(self, depths: tuple[int, ...], bottleneck: bool = False, groups: int = 1,
                 width_per_group: int = 64, *, dtype: torch.dtype | None = None,
                 device: torch.device | str = "cuda", generator: torch.Generator | None = None):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        kw = dict(dtype=dtype, generator=gen)
        self.compute_dtype = torch.float32 if dtype is None else dtype
        self.depths, self.bottleneck = tuple(depths), bottleneck
        self.stem = ConvNormAct(3, 64, 7, 2, **kw)
        in_ch, self.block_names = 64, []
        for i, depth in enumerate(self.depths):
            out_ch = self.out_channels_list[i]
            names = []
            for j in range(depth):
                stride = 2 if i > 0 and j == 0 else 1
                block = (Bottleneck(in_ch, out_ch, stride, groups, width_per_group, **kw)
                         if bottleneck else BasicBlock(in_ch, out_ch, stride, **kw))
                names.append(f"layer{i + 1}_block{j}")
                setattr(self, names[-1], block)
                in_ch = out_ch
            self.block_names.append(names)
        to_device(self, device)

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        expansion = 4 if self.bottleneck else 1
        return tuple(64 * expansion * 2**i for i in range(len(self.depths)))

    @property
    def stride(self) -> int:
        return 4 * 2 ** (len(self.depths) - 1)

    def get_feature_maps(self, x: Tensor, train: bool = False) -> list[Tensor]:
        """x: (B, H, W, 3) NHWC → the four stages' NHWC outputs."""
        x = max_pool_torch(self.stem(x, train), 3, 2, 1)
        outputs = []
        for names in self.block_names:
            for name in names:
                x = getattr(self, name)(x, train)
            outputs.append(x)
        return outputs


# (depths, bottleneck, extra), vision_toolbox_tpu/models/resnet.py
_RESNET_VARIANTS = {
    "resnet18": ((2, 2, 2, 2), False, {}),
    "resnet34": ((3, 4, 6, 3), False, {}),
    "resnet50": ((3, 4, 6, 3), True, {}),
    "resnet101": ((3, 4, 23, 3), True, {}),
    "resnet152": ((3, 8, 36, 3), True, {}),
    "resnext50_32x4d": ((3, 4, 6, 3), True, {"groups": 32, "width_per_group": 4}),
    "resnext101_32x8d": ((3, 4, 23, 3), True, {"groups": 32, "width_per_group": 8}),
    "wide_resnet50_2": ((3, 4, 6, 3), True, {"width_per_group": 128}),
    "wide_resnet101_2": ((3, 4, 23, 3), True, {"width_per_group": 128}),
}


def resnet_from_config(variant: str, **kwargs: Any) -> ResNet:
    depths, bottleneck, extra = _RESNET_VARIANTS[variant]
    return ResNet(depths, bottleneck, **extra, **kwargs)


for _v in _RESNET_VARIANTS:
    register_model(_v)(lambda variant=_v, **kw: resnet_from_config(variant, **kw))
