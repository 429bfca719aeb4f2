"""Parameter initializers — port of ``vision_toolbox_tpu/nn/initializers.py``
(the part ViT and the convnets use).

Each initializer is ``init(shape, generator) -> Tensor`` and draws on the CPU
in float32 from an explicit ``torch.Generator``, so a seed gives the same
weights on every device; modules move them afterwards. Shapes are in the
PyTorch layouts: (out, in) for linear weights, (out, in, kh, kw) for convs.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Init = Callable[[tuple[int, ...], torch.Generator], torch.Tensor]


def _fan_in(shape: tuple[int, ...]) -> int:
    return math.prod(shape[1:])


def _uniform(shape: tuple[int, ...], bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def kaiming_normal(nonlinearity: str = "relu", a: float = 0.2, mode: str = "fan_out") -> Init:
    """``torch.nn.init.kaiming_normal_``: N(0, (gain/√fan)²) with gain √2 for
    relu and √(2/(1+a²)) for leaky_relu (``a`` is read only there)."""
    if nonlinearity == "relu":
        gain = math.sqrt(2.0)
    elif nonlinearity == "leaky_relu":
        gain = math.sqrt(2.0 / (1.0 + a**2))
    else:
        raise ValueError(f"unsupported nonlinearity {nonlinearity}")

    def init(shape, generator):
        fan_in = _fan_in(shape)
        fan = shape[0] * math.prod(shape[2:]) if mode == "fan_out" else fan_in
        return torch.empty(shape).normal_(0.0, gain / math.sqrt(fan), generator=generator)

    return init


def torch_default_kernel(shape: tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """PyTorch's default Conv2d/Linear weight init, kaiming_uniform_(a=√5):
    U(-1/√fan_in, 1/√fan_in)."""
    fan_in = _fan_in(shape)
    return _uniform(shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, generator)


def torch_default_bias(fan_in: int) -> Init:
    """PyTorch's default bias init: U(-1/√fan_in, 1/√fan_in)."""

    def init(shape, generator):
        return _uniform(shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, generator)

    return init


def normal(std: float) -> Init:
    """N(0, std²) — flax ``nn.initializers.normal`` (ViT position embedding)."""

    def init(shape, generator):
        return torch.empty(shape).normal_(0.0, std, generator=generator)

    return init


def trunc_normal(std: float = 0.02) -> Init:
    """N(0, std²) truncated at ±2σ — the JAX package's ``trunc_normal``
    (``torch.nn.init.trunc_normal_``; Swin's relative-position tables)."""

    def init(shape, generator):
        return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)

    return init
