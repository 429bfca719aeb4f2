"""The inverted-residual (MBConv) block of MobileNetV3 and EfficientNet —
port of ``vision_toolbox_tpu/models/mbconv.py``.

expand 1×1 (when the expanded width differs from the input's) → depthwise
k×k at the block's stride → optional SE → project 1×1 (no activation),
with drop-path on the residual branch when the stride is 1 and the width
is kept. Every ``ConvNormAct`` has BatchNorm with eps 1e-3 and flax momentum
0.99 (torch's 0.01). The stride-1 depthwise conv is ``ConvNormAct``'s K9
branch (the CUDA kernels on the card); the stride-2 one a grouped
``Conv2d`` (cuDNN), as XLA runs it in the JAX package. NHWC tensors; module
names follow the JAX tree (``expand``, ``dwconv``, ``se``, ``project``,
``droppath``).
"""

from __future__ import annotations

import torch
from torch import Tensor, nn

from ..nn.layers import ConvNormAct, SqueezeExcitation, StochasticDepth


def make_divisible(v: float, divisor: int = 8) -> int:
    """``v`` rounded to a multiple of ``divisor``, never below it nor more
    than 10% below ``v`` (torchvision's ``_make_divisible``)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class MBConv(nn.Module):
    def __init__(self, in_channels: int, expanded_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, se_channels: int | None = None,
                 se_act: str = "relu", se_gate: str = "hardsigmoid", act: str = "hardswish",
                 stochastic_depth: float = 0.0, norm_eps: float = 1e-3,
                 norm_momentum: float = 0.99, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(norm_eps=norm_eps, norm_momentum=norm_momentum, dtype=dtype,
                  generator=generator)
        self.expand = (ConvNormAct(in_channels, expanded_channels, 1, act=act, **kw)
                       if expanded_channels != in_channels else None)
        self.dwconv = ConvNormAct(expanded_channels, expanded_channels, kernel_size, stride,
                                  groups=expanded_channels, act=act, **kw)
        self.se = (SqueezeExcitation(expanded_channels, se_channels, se_act, se_gate, dtype=dtype,
                                     generator=generator) if se_channels else None)
        self.project = ConvNormAct(expanded_channels, out_channels, 1, act="none", **kw)
        self.stride, self.residual = stride, stride == 1 and in_channels == out_channels
        self.droppath = StochasticDepth(stochastic_depth) if self.residual else None

    def forward(self, x: Tensor, train: bool = False, tap_expansion: bool = False, *,
                plain: bool = False, generator: torch.Generator | None = None):
        """The block's output, and with ``tap_expansion`` also the expansion
        conv's (the detection tap); ``plain`` runs K9's plain versions."""
        y = x if self.expand is None else self.expand(x, train)
        expanded = y
        y = self.dwconv(y, train, plain=plain)
        if self.se is not None:
            y = self.se(y)
        y = self.project(y, train)
        if self.residual:
            y = self.droppath(y, train=train, generator=generator) + x
        return (y, expanded) if tap_expansion else y
