"""VoVNet V1/V2 (One-Shot Aggregation networks) — port of
``vision_toolbox_tpu/models/vovnet.py``.

- ``OSABlock`` = n chained 3×3 ``ConvNormAct``, a channel concat of the
  input and every output, a 1×1 ``out_conv``, the optional eSE gate
  (``ESEBlock``) and a residual when in == out channels;
- the stem is three ``ConvNormAct`` (the first stride 2); each stage is a
  3×3/2 max pool (``max_pool_torch``) and its OSA blocks.

No TPU kernel runs in the model: cuDNN runs the convs (XLA in the JAX
package), the port's ``BatchNorm`` their norms. Images and feature maps are
NHWC; ``get_feature_maps`` returns the stem's and every stage's output.
Parameters are float32, drawn on the CPU from an explicit
``torch.Generator`` (seed 0 when none is given) and moved to ``device``,
the card unless the caller asks for another; ``dtype`` is the compute type.
Module names follow the JAX tree (``stem_<i>``, ``conv_<i>``, ``out_conv``,
``ese/linear``); its ``stage_<i>_block_<j>`` are ``stages.<i>.<j>`` here.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor, nn

from ..nn.layers import ConvNormAct, ESEBlock, max_pool_torch
from .base import Backbone, register_model, to_device


class OSABlock(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int, num_layers: int, out_channels: int,
                 ese: bool = True, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.num_layers, self.residual = num_layers, in_channels == out_channels
        for i in range(num_layers):
            setattr(self, f"conv_{i}", ConvNormAct(mid_channels if i else in_channels,
                                                   mid_channels, 3, **kw))
        self.out_conv = ConvNormAct(in_channels + num_layers * mid_channels, out_channels, 1,
                                    **kw)
        self.ese = ESEBlock(out_channels, **kw) if ese else None

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        outputs, y = [x], x
        for i in range(self.num_layers):
            y = getattr(self, f"conv_{i}")(y, train)
            outputs.append(y)
        out = self.out_conv(torch.cat(outputs, dim=-1), train)
        if self.ese is not None:
            out = self.ese(out)
        return out + x if self.residual else out


class VoVNet(Backbone):
    def __init__(self, stem_channels: int, stage_configs: tuple[tuple[int, int, int, int], ...],
                 ese: bool = True, *, dtype: torch.dtype | None = None,
                 device: torch.device | str = "cuda", generator: torch.Generator | None = None):
        """``stage_configs``: (blocks, mid channels, layers, out channels) per
        stage."""
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        kw = dict(dtype=dtype, generator=gen)
        self.compute_dtype = torch.float32 if dtype is None else dtype
        self.stem_channels, self.stage_configs = stem_channels, tuple(stage_configs)
        half = stem_channels // 2
        self.stem_0 = ConvNormAct(3, half, 3, stride=2, **kw)
        self.stem_1 = ConvNormAct(half, half, 3, **kw)
        self.stem_2 = ConvNormAct(half, stem_channels, 3, **kw)
        in_ch, self.stages = stem_channels, nn.ModuleList()
        for n_blocks, mid_ch, n_layers, out_ch in self.stage_configs:
            blocks = nn.ModuleList()
            for _ in range(n_blocks):
                blocks.append(OSABlock(in_ch, mid_ch, n_layers, out_ch, ese, **kw))
                in_ch = out_ch
            self.stages.append(blocks)
        to_device(self, device)

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        return (self.stem_channels,) + tuple(cfg[3] for cfg in self.stage_configs)

    @property
    def stride(self) -> int:
        return 2 ** len(self.out_channels_list)

    def get_feature_maps(self, x: Tensor, train: bool = False) -> list[Tensor]:
        x = self.stem_2(self.stem_1(self.stem_0(x, train), train), train)
        outputs = [x]
        for blocks in self.stages:
            x = max_pool_torch(x, 3, 2, 1)
            for block in blocks:
                x = block(x, train)
            outputs.append(x)
        return outputs


# (blocks per stage, layers per block), vision_toolbox_tpu/models/vovnet.py
_VOVNET_TABLES = {
    19: ((1, 1, 1, 1), (3, 3, 3, 3)),
    27: ((1, 1, 1, 1), (5, 5, 5, 5)),
    39: ((1, 1, 2, 2), (5, 5, 5, 5)),
    57: ((1, 1, 4, 3), (5, 5, 5, 5)),
    99: ((1, 3, 9, 3), (5, 5, 5, 5)),
}


def vovnet_from_config(variant: int, slim: bool = False, ese: bool = False,
                       **kwargs: Any) -> VoVNet:
    mid_channels_list = (64, 80, 96, 112) if slim else (128, 160, 192, 224)
    out_channels_list = (128, 256, 384, 512) if slim else (256, 512, 768, 1024)
    n_blocks_list, n_layers_list = _VOVNET_TABLES[variant]
    stage_configs = tuple(zip(n_blocks_list, mid_channels_list, n_layers_list,
                              out_channels_list))
    return VoVNet(stem_channels=128, stage_configs=stage_configs, ese=ese, **kwargs)


for _variant, _slim, _ese in ((19, True, True), (19, False, True), (27, True, False),
                              (39, False, False), (39, False, True), (57, False, False),
                              (57, False, True), (99, False, True)):
    register_model(f"vovnet{_variant}" + ("_slim" if _slim else "") + ("_ese" if _ese else ""))(
        lambda variant=_variant, slim=_slim, ese=_ese, **kw: vovnet_from_config(
            variant, slim=slim, ese=ese, **kw))
