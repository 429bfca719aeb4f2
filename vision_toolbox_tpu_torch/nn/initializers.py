"""Parameter initializers — port of ``vision_toolbox_tpu/nn/initializers.py``
(the part ViT uses).

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
