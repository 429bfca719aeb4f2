"""Core NN primitives — port of ``vision_toolbox_tpu/nn/layers.py``: the
activation table, ``torch_pad``, ``Conv2d`` and ``ConvNormAct`` for the
convnets, and ``Linear``, ``LayerNorm`` (flax semantics), ``LayerScale``,
``StochasticDepth`` and the exact-erf GELU for the transformers.

Conv layers take and return NHWC tensors, as in the JAX package; inside, the
NHWC tensor is viewed as a ``channels_last`` NCHW tensor, so no copy is made
on either side of the convolution. Their parameters stay float32 and are
cast to the compute ``dtype`` at use, as flax's ``promote_dtype`` does.
Every random draw takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .initializers import kaiming_normal, torch_default_bias, torch_default_kernel


def _gelu_exact(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="none")


ACTIVATIONS: dict[str, Callable | None] = {
    "none": None,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "swish": F.silu,
    "silu": F.silu,
    "gelu": _gelu_exact,  # torch nn.GELU default is exact erf, not tanh approx
    "hardsigmoid": F.hardsigmoid,
    "hardswish": F.hardswish,
    "relu6": F.relu6,
}


def as_dtype(t: Tensor, dtype: torch.dtype) -> Tensor:
    """``t`` in ``dtype``: ``t`` itself when it already is, so that a model
    exported with its parameters cast once (``torch.export``) carries no
    cast nodes for them."""
    return t if t.dtype == dtype else t.to(dtype)


def torch_pad(kernel_size: int, stride: int = 1) -> int:
    """Symmetric per-side padding of every reference conv: ceil((k − s)/2)."""
    return math.ceil((kernel_size - stride) / 2)


def dropout(x: Tensor, p: float, generator: torch.Generator | None) -> Tensor:
    """Inverted dropout with keep probability 1 − p, mask from ``generator``."""
    if p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=generator.device).to(x.device) >= p
    return x * keep / (1.0 - p)


class Conv2d(nn.Module):
    """k×k convolution on NHWC tensors with explicit symmetric padding.
    ``weight`` is (out, in/groups, k, k), float32."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1, use_bias: bool = True, *,
                 kernel_init: Callable = torch_default_kernel, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.dtype = dtype
        shape = (out_channels, in_channels // groups, kernel_size, kernel_size)
        self.weight = nn.Parameter(kernel_init(shape, generator))
        fan_in = in_channels // groups * kernel_size * kernel_size
        self.bias = (nn.Parameter(torch_default_bias(fan_in)((out_channels,), generator))
                     if use_bias else None)

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)  # flax promote_dtype
        w = self.weight.to(dt, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w, b, self.stride, self.padding,
                     self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class ConvNormAct(nn.Module):
    """Conv → Norm → Act on NHWC tensors, the primitive of every convnet.

    Bias only when ``norm == "none"``; norm ∈ {none, bn}; Kaiming-normal
    (fan_out) init for relu/leaky_relu convs, PyTorch's default otherwise.
    The depthwise stride-1 case is the JAX package's ``DepthwiseConv``, whose
    TPU kernel K9 is not ported yet: on a CUDA tensor it raises
    ``NotImplementedError``; on a CPU tensor it runs the grouped convolution.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1, norm: str = "bn",
                 act: str = "relu", norm_eps: float = 1e-5, norm_momentum: float = 0.9, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        from .norm import BatchNorm

        k, s = kernel_size, stride
        if act in ("relu", "leaky_relu"):
            kernel_init = kaiming_normal(act, a=0.2, mode="fan_out")
        else:
            kernel_init = torch_default_kernel
        self.depthwise = (groups == in_channels == out_channels and s == 1 and dilation == 1
                          and k % 2 == 1)
        self.conv = Conv2d(in_channels, out_channels, k, s, torch_pad(k, s), dilation, groups,
                           use_bias=norm == "none", kernel_init=kernel_init, dtype=dtype,
                           generator=generator)
        if norm == "bn":
            self.norm = BatchNorm(out_channels, momentum=norm_momentum, eps=norm_eps)
        elif norm == "none":
            self.norm = None
        else:
            raise ValueError(f"unsupported norm {norm}")
        self.act = ACTIVATIONS[act]

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        if self.depthwise and x.is_cuda:
            raise NotImplementedError(
                "depthwise stride-1 ConvNormAct runs kernel K9 (depthwise conv, "
                "vision_toolbox_tpu/ops/depthwise_conv.py) in the JAX package; that kernel "
                "has no CUDA port yet"
            )
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x, train=train)
        return x if self.act is None else self.act(x)


class Linear(nn.Module):
    """nn.Linear with PyTorch's default init drawn from an explicit generator.
    ``weight`` is (out_features, in_features). With ``dtype`` set, input and
    parameters are cast to it at use."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch_default_kernel((out_features, in_features), generator))
        self.bias = (
            nn.Parameter(torch_default_bias(in_features)((out_features,), generator))
            if use_bias else None
        )

    def forward(self, x: Tensor) -> Tensor:
        if self.dtype is None:
            return F.linear(x, self.weight, self.bias)
        dt = self.dtype
        bias = None if self.bias is None else as_dtype(self.bias, dt)
        return F.linear(as_dtype(x, dt), as_dtype(self.weight, dt), bias)


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float) -> Tensor:
    """flax ``nn.LayerNorm``: statistics in f32 with the fast variance
    max(E[x²] − E[x]², 0), ``(x − μ)·(rsqrt(var + eps)·γ) + β``, cast back to
    ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``; its parameters stay float32 in a bf16 model,
    as flax keeps them."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: Tensor) -> Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class StochasticDepth(nn.Module):
    """Per-sample drop-path, train only, rescaled by the keep probability."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def sample_scale(self, batch: int, train: bool = False,
                     generator: torch.Generator | None = None, *, device=None) -> Tensor | None:
        """(batch, 1) f32 mask/keep_p scale for the fused kernels, drawn from
        ``generator``, or None when this is an identity."""
        if not train or self.p == 0.0:
            return None
        if generator is None:
            raise ValueError("stochastic depth in training needs an explicit torch.Generator")
        keep_p = 1.0 - self.p
        mask = torch.rand((batch, 1), generator=generator, device=generator.device) < keep_p
        return (mask.float() / keep_p).to(device)

    def forward(self, x: Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> Tensor:
        scale = self.sample_scale(x.shape[0], train, generator, device=x.device)
        if scale is None:
            return x
        return x * scale.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)


class LayerScale(nn.Module):
    """Learnable per-channel γ multiplier."""

    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x: Tensor) -> Tensor:
        return x * as_dtype(self.gamma, x.dtype)
