"""Darknet family: Darknet-19/53, CSPDarknet-53, YOLOv5 backbones — port of
``vision_toolbox_tpu/models/darknet.py``.

- ``DarknetBlock`` = 1×1 reduce + 3×3 + residual;
- ``DarknetStage`` = stride-2 conv + n blocks;
- ``CSPDarknetStage`` = stride-2 conv, two 1×1 branches from it, blocks on
  the second, channel concat, 1×1 out;
- a stage with 0 blocks is a single stride-2 conv.

Images and feature maps are NHWC, as in the JAX package (``channels_last``
NCHW inside the convolutions, no copies). Parameters are float32, drawn on
the CPU from an explicit ``torch.Generator`` (seed 0 when none is given) and
moved to ``device``; ``dtype`` is the compute type (bf16 for training), cast
at use. Module names follow the flax tree (``stem``, ``stage_<i>``,
``blocks.<i>`` for ``block_<i>``, ``conv``/``conv1``/``conv2``/``out_conv``,
``norm``), so ``utils/jax_bridge.py`` maps a JAX model's variables onto it.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor, nn

from ..nn.layers import ConvNormAct
from .base import Backbone, register_model


class DarknetBlock(nn.Module):
    def __init__(self, in_channels: int, expansion: float = 0.5, *, dtype=None,
                 generator: torch.Generator):
        super().__init__()
        mid = int(in_channels * expansion)
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = ConvNormAct(in_channels, mid, 1, **kw)
        self.conv2 = ConvNormAct(mid, in_channels, 3, **kw)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        return x + self.conv2(self.conv1(x, train), train)


class DarknetStage(nn.Module):
    def __init__(self, in_channels: int, n_blocks: int, out_channels: int, *, dtype=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.conv = ConvNormAct(in_channels, out_channels, 3, stride=2, **kw)
        self.blocks = nn.ModuleList(DarknetBlock(out_channels, **kw) for _ in range(n_blocks))

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        x = self.conv(x, train)
        for block in self.blocks:
            x = block(x, train)
        return x


class CSPDarknetStage(nn.Module):
    def __init__(self, in_channels: int, n_blocks: int, out_channels: int, *, dtype=None,
                 generator: torch.Generator):
        super().__init__()
        if n_blocks <= 0:
            raise ValueError("a CSP stage needs at least one block")
        kw = dict(dtype=dtype, generator=generator)
        half = out_channels // 2
        self.conv = ConvNormAct(in_channels, out_channels, 3, stride=2, **kw)
        self.conv1 = ConvNormAct(out_channels, half, 1, **kw)
        self.conv2 = ConvNormAct(out_channels, half, 1, **kw)
        self.blocks = nn.ModuleList(
            DarknetBlock(half, expansion=1.0, **kw) for _ in range(n_blocks)
        )
        self.out_conv = ConvNormAct(2 * half, out_channels, 1, **kw)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        x = self.conv(x, train)
        a = self.conv1(x, train)
        b = self.conv2(x, train)
        for block in self.blocks:
            b = block(b, train)
        return self.out_conv(torch.cat([a, b], dim=-1), train)


def _generator(generator: torch.Generator | None) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


class Darknet(Backbone):
    """Darknet-19/53 and CSPDarknet-53."""

    def __init__(self, stem_channels: int, stage_configs: tuple[tuple[int, int], ...],
                 csp: bool = False, *, dtype: torch.dtype | None = None,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = _generator(generator)
        kw = dict(dtype=dtype, generator=gen)
        self.stage_configs = tuple(stage_configs)
        self.stem = ConvNormAct(3, stem_channels, 3, **kw)
        in_ch = stem_channels
        for i, (n_blocks, out_ch) in enumerate(self.stage_configs):
            if n_blocks == 0:
                stage = ConvNormAct(in_ch, out_ch, 3, stride=2, **kw)
            elif csp:
                stage = CSPDarknetStage(in_ch, n_blocks, out_ch, **kw)
            else:
                stage = DarknetStage(in_ch, n_blocks, out_ch, **kw)
            self.add_module(f"stage_{i}", stage)
            in_ch = out_ch
        self.to(device)

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        return tuple(cfg[1] for cfg in self.stage_configs)

    @property
    def stride(self) -> int:
        return 32

    def get_feature_maps(self, x: Tensor, train: bool = False) -> list[Tensor]:
        x = self.stem(x, train)
        outputs = []
        for i in range(len(self.stage_configs)):
            x = getattr(self, f"stage_{i}")(x, train)
            outputs.append(x)
        return outputs


class DarknetYOLOv5(Backbone):
    """YOLOv5 backbone without SPPF: 6×6/2 stem + 4 CSP stages; the feature
    maps include the stem output."""

    def __init__(self, stem_channels: int, stage_configs: tuple[tuple[int, int], ...], *,
                 dtype: torch.dtype | None = None, device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = _generator(generator)
        kw = dict(dtype=dtype, generator=gen)
        self.stem_channels = stem_channels
        self.stage_configs = tuple(stage_configs)
        self.stem = ConvNormAct(3, stem_channels, 6, stride=2, **kw)
        in_ch = stem_channels
        for i, (n_blocks, out_ch) in enumerate(self.stage_configs):
            self.add_module(f"stage_{i}", CSPDarknetStage(in_ch, n_blocks, out_ch, **kw))
            in_ch = out_ch
        self.to(device)

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        return (self.stem_channels,) + tuple(cfg[1] for cfg in self.stage_configs)

    @property
    def stride(self) -> int:
        return 2 ** len(self.out_channels_list)

    def get_feature_maps(self, x: Tensor, train: bool = False) -> list[Tensor]:
        x = self.stem(x, train)
        outputs = [x]
        for i in range(len(self.stage_configs)):
            x = getattr(self, f"stage_{i}")(x, train)
            outputs.append(x)
        return outputs


_DARKNET_VARIANTS = {
    "darknet19": ((0, 1, 1, 2, 2), False),
    "darknet53": ((1, 2, 8, 8, 4), False),
    "cspdarknet53": ((1, 2, 8, 8, 4), True),
}

_YOLOV5_VARIANTS = {
    "n": (1 / 3, 1 / 4),
    "s": (1 / 3, 1 / 2),
    "m": (2 / 3, 3 / 4),
    "l": (1.0, 1.0),
    "x": (4 / 3, 5 / 4),
}


def darknet_from_config(variant: str, **kwargs: Any) -> Darknet:
    n_blocks_list, csp = _DARKNET_VARIANTS[variant]
    stage_configs = tuple(zip(n_blocks_list, (64, 128, 256, 512, 1024)))
    return Darknet(stem_channels=32, stage_configs=stage_configs, csp=csp, **kwargs)


def darknet_yolov5_from_config(variant: str, **kwargs: Any) -> DarknetYOLOv5:
    depth_scale, width_scale = _YOLOV5_VARIANTS[variant]
    stage_configs = tuple(
        (int(d * depth_scale), int(w * width_scale))
        for d, w in zip((3, 6, 9, 3), (128, 256, 512, 1024))
    )
    return DarknetYOLOv5(stem_channels=int(64 * width_scale), stage_configs=stage_configs,
                         **kwargs)


for _v in _DARKNET_VARIANTS:
    register_model(_v)(lambda variant=_v, **kw: darknet_from_config(variant, **kw))
for _v in _YOLOV5_VARIANTS:
    register_model(f"darknet_yolov5{_v}")(
        lambda variant=_v, **kw: darknet_yolov5_from_config(variant, **kw)
    )
