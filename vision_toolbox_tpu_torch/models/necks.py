"""Detection necks FPN, PAN and BiFPN — port of
``vision_toolbox_tpu/models/necks.py``.

- ``FPN``: a lateral 1×1 conv per level (none where the width already
  matches), fuse ∈ {concat, sum, avg, max} with the neighbour resized by
  ``resize_nearest`` (2× top-down, 0.5× with ``top_down=False``), then an
  output block (``ConvNormAct`` 3×3 or ``SeparableConv2d``).
- ``PAN``: a top-down FPN, then a bottom-up one.
- ``BiFPN``: a lateral 1×1 conv per level, then stacked ``BiFPNLayer``s of
  ``WeightedFeatureFusion`` (ReLU'd learnable weights, normalised, then a
  separable conv: its depthwise half a K9 conv on the card, 8 a layer on
  five levels).

Feature maps are NHWC, ordered from the largest to the smallest. The
modules' widths are given at construction (the JAX modules read them off
their inputs). Parameters are float32, drawn on the CPU from an explicit
``torch.Generator`` (seed 0 when none is given) and moved to ``device``, the
card unless the caller asks for another; ``dtype`` is the compute type.
Module names follow the JAX tree (``lateral_<i>``, ``out_conv_<i>``,
``top_down``, ``bottom_up``, ``layer_<i>``, ``td_fuse_<i>``,
``out_fuse_<i>``, ``last_out_fuse``, ``weights``, ``conv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..nn.layers import Conv2d, ConvNormAct, SeparableConv2d
from .base import to_device


def _fuse(name: str, xs: list[Tensor]) -> Tensor:
    if name == "concat":
        return torch.cat(xs, dim=-1)
    if name == "sum":
        return xs[0] + xs[1]
    if name == "avg":
        return (xs[0] + xs[1]) / 2
    if name == "max":
        return torch.maximum(xs[0], xs[1])
    raise ValueError(f"unknown fuse {name}")


def resize_nearest(x: Tensor, scale: float) -> Tensor:
    """``jax.image.resize(..., "nearest")`` to int(H·scale) × int(W·scale) on
    NHWC: output pixel i reads input ⌊(i + ½)·in/out⌋, which is torch's
    ``"nearest-exact"`` (torch's ``"nearest"`` reads ⌊i·in/out⌋: at 0.5 the
    even pixels where JAX takes the odd)."""
    B, H, W, C = x.shape
    size = (int(H * scale), int(W * scale))
    return F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="nearest-exact").permute(
        0, 2, 3, 1)


class _Lateral(nn.Module):
    """A 1×1 conv ``conv`` with bias to ``out_channels``, or the identity
    where the width already matches."""

    def __init__(self, in_channels: int, out_channels: int, *, dtype: torch.dtype | None,
                 generator: torch.Generator):
        super().__init__()
        self.conv = (Conv2d(in_channels, out_channels, 1, dtype=dtype, generator=generator)
                     if in_channels != out_channels else None)

    def forward(self, x: Tensor) -> Tensor:
        return x if self.conv is None else self.conv(x)


def _block(kind: str, in_channels: int, out_channels: int, dtype, generator) -> nn.Module:
    if kind == "separable":
        return SeparableConv2d(in_channels, out_channels, dtype=dtype, generator=generator)
    return ConvNormAct(in_channels, out_channels, dtype=dtype, generator=generator)


def _generator(generator: torch.Generator | None) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


class FPN(nn.Module):
    def __init__(self, in_channels_list: tuple[int, ...], out_channels: int = 256,
                 fuse: str = "sum", block: str = "conv_norm_act", top_down: bool = True, *,
                 dtype: torch.dtype | None = None, device: torch.device | str = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = _generator(generator)
        self.in_channels_list, self.fuse, self.top_down = tuple(in_channels_list), fuse, top_down
        fused = 2 * out_channels if fuse == "concat" else out_channels
        for i, c in enumerate(self.in_channels_list):
            setattr(self, f"lateral_{i}", _Lateral(c, out_channels, dtype=dtype, generator=gen))
        for i in range(len(self.in_channels_list) - 1):
            setattr(self, f"out_conv_{i}", _block(block, fused, out_channels, dtype, gen))
        to_device(self, device)

    def forward(self, xs: list[Tensor], train: bool = False, *,
                plain: bool = False) -> list[Tensor]:
        """``plain`` runs the separable blocks' K9 plain versions."""
        if len(xs) != len(self.in_channels_list):
            raise ValueError(f"FPN: {len(xs)} maps for {len(self.in_channels_list)} levels")
        outputs = [getattr(self, f"lateral_{i}")(x) for i, x in enumerate(xs)]
        n = len(outputs)
        for i in range(n - 1):
            block = getattr(self, f"out_conv_{i}")
            if self.top_down:
                up = resize_nearest(outputs[-1 - i], 2.0)
                outputs[-2 - i] = block(_fuse(self.fuse, [outputs[-2 - i], up]), train,
                                        plain=plain)
            else:
                down = resize_nearest(outputs[i], 0.5)
                outputs[i + 1] = block(_fuse(self.fuse, [outputs[i + 1], down]), train,
                                       plain=plain)
        return outputs


class PAN(nn.Module):
    def __init__(self, in_channels_list: tuple[int, ...], out_channels: int = 256,
                 fuse: str = "sum", block: str = "conv_norm_act", *,
                 dtype: torch.dtype | None = None, device: torch.device | str = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=_generator(generator))
        self.top_down = FPN(in_channels_list, out_channels, fuse, block, True, **kw)
        self.bottom_up = FPN((out_channels,) * len(in_channels_list), out_channels, fuse, block,
                             False, **kw)

    def forward(self, xs: list[Tensor], train: bool = False, *,
                plain: bool = False) -> list[Tensor]:
        return self.bottom_up(self.top_down(xs, train, plain=plain), train, plain=plain)


class WeightedFeatureFusion(nn.Module):
    """Σ xᵢ·relu(wᵢ) / (Σ relu(w) + eps), then the block ``conv``, at the
    JAX module's rounding points: each weight cast to x's type before its
    product, the division by the f32 sum rounded to x's type."""

    def __init__(self, channels: int, num_inputs: int = 2, block: str = "separable",
                 eps: float = 1e-4, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        self.eps = eps
        self.weights = nn.Parameter(torch.ones(num_inputs))
        self.conv = _block(block, channels, channels, dtype, generator)

    def forward(self, xs: list[Tensor], train: bool = False, *, plain: bool = False) -> Tensor:
        if len(xs) != self.weights.shape[0]:
            raise ValueError(f"WeightedFeatureFusion: {len(xs)} inputs for "
                             f"{self.weights.shape[0]} weights")
        w = F.relu(self.weights)
        out = xs[0] * w[0].to(xs[0].dtype)
        for i in range(1, len(xs)):
            out = out + xs[i] * w[i].to(xs[i].dtype)
        out = out / (w.sum() + self.eps).to(out.dtype)
        return self.conv(out, train, plain=plain)


class BiFPNLayer(nn.Module):
    """A top-down pass of two-input fusions, a bottom-up pass of
    three-input fusions and a two-input fusion at the top level."""

    def __init__(self, channels: int, num_levels: int, block: str = "separable",
                 eps: float = 1e-4, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        self.num_levels = num_levels
        kw = dict(block=block, eps=eps, dtype=dtype, generator=generator)
        for i in range(num_levels - 1):
            setattr(self, f"td_fuse_{i}", WeightedFeatureFusion(channels, 2, **kw))
        for i in range(num_levels - 2):
            setattr(self, f"out_fuse_{i}", WeightedFeatureFusion(channels, 3, **kw))
        self.last_out_fuse = WeightedFeatureFusion(channels, 2, **kw)

    def forward(self, xs: list[Tensor], train: bool = False, *,
                plain: bool = False) -> list[Tensor]:
        n = self.num_levels
        tds = list(xs)
        for i in range(n - 1):
            tds[-2 - i] = getattr(self, f"td_fuse_{i}")(
                [xs[-2 - i], resize_nearest(tds[-1 - i], 2.0)], train, plain=plain)
        outs = list(tds)
        for i in range(n - 2):
            outs[i + 1] = getattr(self, f"out_fuse_{i}")(
                [xs[i + 1], tds[i + 1], resize_nearest(tds[i], 0.5)], train, plain=plain)
        outs[-1] = self.last_out_fuse([xs[-1], resize_nearest(tds[-2], 0.5)], train, plain=plain)
        return outs


class BiFPN(nn.Module):
    def __init__(self, in_channels_list: tuple[int, ...], out_channels: int = 64,
                 num_layers: int = 1, block: str = "separable", eps: float = 1e-4, *,
                 dtype: torch.dtype | None = None, device: torch.device | str = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = _generator(generator)
        self.in_channels_list, self.num_layers = tuple(in_channels_list), num_layers
        for i, c in enumerate(self.in_channels_list):
            setattr(self, f"lateral_{i}", Conv2d(c, out_channels, 1, dtype=dtype, generator=gen))
        for i in range(num_layers):
            setattr(self, f"layer_{i}", BiFPNLayer(out_channels, len(self.in_channels_list),
                                                   block, eps, dtype=dtype, generator=gen))
        to_device(self, device)

    def forward(self, xs: list[Tensor], train: bool = False, *,
                plain: bool = False) -> list[Tensor]:
        """``plain`` runs the separable convs' K9 plain versions."""
        if len(xs) != len(self.in_channels_list):
            raise ValueError(f"BiFPN: {len(xs)} maps for {len(self.in_channels_list)} levels")
        outputs = [getattr(self, f"lateral_{i}")(x) for i, x in enumerate(xs)]
        for i in range(self.num_layers):
            outputs = getattr(self, f"layer_{i}")(outputs, train, plain=plain)
        return outputs
