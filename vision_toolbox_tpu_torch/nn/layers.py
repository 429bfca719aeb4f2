"""Core NN primitives — port of ``vision_toolbox_tpu/nn/layers.py``: the
activation table, ``torch_pad``, ``Conv2d``, ``DepthwiseConv``,
``ConvNormAct``, ``SeparableConv2d``, ``max_pool_torch``, ``avg_pool_torch``,
``SPPBlock``, the gates ``ESEBlock`` and ``SqueezeExcitation`` and
``DeformableConv2d`` for the convnets and necks, and ``Linear``,
``LayerNorm`` (flax semantics), ``LayerScale``, ``StochasticDepth`` and the
exact-erf GELU for the transformers.

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

from ..ops.deform_conv import deform_conv2d
from ..ops.depthwise_conv import depthwise_conv2d
from .initializers import kaiming_normal, torch_default_bias, torch_default_kernel


def _gelu_exact(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="none")


def hard_sigmoid(x: Tensor) -> Tensor:
    """``jax.nn.hard_sigmoid``, relu6(x + 3) / 6, at XLA's rounding points:
    each step in x's type; in f32 XLA computes the division as a product
    with 1/6, which this repeats (``F.hardsigmoid`` rounds elsewhere)."""
    y = F.relu6(x + 3)
    return y * (1 / 6) if x.dtype == torch.float32 else y / 6


def hard_swish(x: Tensor) -> Tensor:
    """``jax.nn.hard_swish``, x · hard_sigmoid(x), at its rounding points
    (``F.hardswish`` rounds elsewhere in f32 and bf16)."""
    return x * hard_sigmoid(x)


ACTIVATIONS: dict[str, Callable | None] = {
    "none": None,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "swish": F.silu,
    "silu": F.silu,
    "gelu": _gelu_exact,  # torch nn.GELU default is exact erf, not tanh approx
    "hardsigmoid": hard_sigmoid,
    "hardswish": hard_swish,
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
    """Inverted dropout with keep probability 1 − p, mask from ``generator``;
    the division by 1 − p in x's type, as JAX rounds the Python scalar."""
    if p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=generator.device).to(x.device) >= p
    return x * keep / torch.tensor(1.0 - p, dtype=x.dtype)


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


class DepthwiseConv(nn.Module):
    """Depthwise k×k conv, stride 1, SAME, on NHWC tensors — the JAX
    package's ``DepthwiseConv``, param-compatible with it: ``weight``
    (C, 1, k, k) (the bridge's layout of its (k, k, 1, C) kernel) and an
    optional ``bias`` (C,), float32. x, weight and bias are cast to
    ``dtype`` (else their promoted type) as flax's ``promote_dtype`` does;
    the conv runs ``ops/depthwise_conv.py`` (the K9 kernels on CUDA tensors,
    their plain versions on CPU tensors) and the bias is added after its
    output is rounded, in the compute type."""

    def __init__(self, channels: int, kernel_size: int, use_bias: bool = True, *,
                 kernel_init: Callable = torch_default_kernel, bias_init: Callable | None = None,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        k = kernel_size
        self.dtype = dtype
        self.weight = nn.Parameter(kernel_init((channels, 1, k, k), generator))
        init = bias_init or torch_default_bias(k * k)
        self.bias = nn.Parameter(init((channels,), generator)) if use_bias else None

    def forward(self, x: Tensor, *, plain: bool = False) -> Tensor:
        """``plain`` runs the kernels' plain versions on any device."""
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        w = as_dtype(self.weight, dt).permute(2, 3, 1, 0)  # (k, k, 1, C), the JAX layout
        y = depthwise_conv2d(as_dtype(x, dt), w, plain=plain)
        return y if self.bias is None else y + as_dtype(self.bias, dt)


class ConvNormAct(nn.Module):
    """Conv → Norm → Act on NHWC tensors, the primitive of every convnet.

    Bias only when ``norm == "none"``; norm ∈ {none, bn}; Kaiming-normal
    (fan_out) init for relu/leaky_relu convs, PyTorch's default otherwise.
    The depthwise stride-1 case (odd k, groups = in = out channels) is a
    ``DepthwiseConv`` under the same ``conv`` name, as in the JAX package:
    the K9 kernels on CUDA tensors.
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
        if self.depthwise:
            self.conv = DepthwiseConv(out_channels, k, norm == "none", kernel_init=kernel_init,
                                      bias_init=torch_default_bias(k * k), dtype=dtype,
                                      generator=generator)
        else:
            self.conv = Conv2d(in_channels, out_channels, k, s, torch_pad(k, s), dilation,
                               groups, use_bias=norm == "none", kernel_init=kernel_init,
                               dtype=dtype, generator=generator)
        if norm == "bn":
            self.norm = BatchNorm(out_channels, momentum=norm_momentum, eps=norm_eps)
        elif norm == "none":
            self.norm = None
        else:
            raise ValueError(f"unsupported norm {norm}")
        self.act = ACTIVATIONS[act]

    def forward(self, x: Tensor, train: bool = False, *, plain: bool = False) -> Tensor:
        """``plain`` runs the depthwise branch's plain K9 versions on any
        device."""
        x = self.conv(x, plain=plain) if self.depthwise else self.conv(x)
        if self.norm is not None:
            x = self.norm(x, train=train)
        return x if self.act is None else self.act(x)


class SeparableConv2d(nn.Module):
    """Depthwise + pointwise ``ConvNormAct`` (``dw``, ``pw``), as in the JAX
    package; at stride 1 the depthwise half is a K9 conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, norm: str = "bn", act: str = "relu6", *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        self.dw = ConvNormAct(in_channels, in_channels, kernel_size, stride, dilation,
                              groups=in_channels, norm=norm, act=act, dtype=dtype,
                              generator=generator)
        self.pw = ConvNormAct(in_channels, out_channels, 1, norm=norm, act=act, dtype=dtype,
                              generator=generator)

    def forward(self, x: Tensor, train: bool = False, *, plain: bool = False) -> Tensor:
        return self.pw(self.dw(x, train=train, plain=plain), train=train)


class Linear(nn.Module):
    """nn.Linear, PyTorch's default init (or ``kernel_init``/``bias_init``)
    drawn from an explicit generator. ``weight`` is (out_features,
    in_features). With ``dtype`` set, input and parameters are cast to it at
    use."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True, *,
                 kernel_init: Callable = torch_default_kernel, bias_init: Callable | None = None,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(kernel_init((out_features, in_features), generator))
        init = bias_init or torch_default_bias(in_features)
        self.bias = nn.Parameter(init((out_features,), generator)) if use_bias else None

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
        """x·mask/keep_p at the JAX package's rounding points: XLA computes
        the division as a product with 1/keep_p in f32, and divides by
        keep_p rounded to x's type in bf16."""
        scale = self.sample_scale(x.shape[0], train, generator, device=x.device)
        if scale is None:
            return x
        scale = scale.reshape((-1,) + (1,) * (x.ndim - 1))
        if x.dtype == torch.float32:
            return x * scale
        return x * (scale != 0).to(x.dtype) / torch.tensor(1.0 - self.p, dtype=x.dtype)


class LayerScale(nn.Module):
    """Learnable per-channel γ multiplier."""

    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x: Tensor) -> Tensor:
        return x * as_dtype(self.gamma, x.dtype)


def max_pool_torch(x: Tensor, kernel_size: int, stride: int, padding: int) -> Tensor:
    """torch.nn.MaxPool2d(k, s, p) on NHWC tensors: -inf padded, symmetric.
    The JAX package runs XLA's reduce_window here (no Pallas kernel); both
    send a tied window's gradient to its first maximum in row-major order."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size, stride, padding).permute(0, 2, 3, 1)


def avg_pool_torch(x: Tensor, kernel_size: int, stride: int, padding: int) -> Tensor:
    """torch.nn.AvgPool2d(k, s, p) with count_include_pad on NHWC tensors, as
    the JAX package computes it: the zero-padded window sum, then the
    division by k² in x's type (in f32 XLA makes it a product with 1/k²)."""
    k2 = kernel_size * kernel_size
    summed = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel_size, stride, padding,
                          divisor_override=1).permute(0, 2, 3, 1)
    return summed * (1 / k2) if x.dtype == torch.float32 else summed / k2


class SPPBlock(nn.Module):
    """SPPF-style pooling: ``repeats`` chained k×k stride-1 pools (max or
    avg), their outputs concatenated over channels (k = 5 three times is
    parallel 5/9/13 pooling). No parameters."""

    def __init__(self, kernel_size: int = 5, repeats: int = 3, pool: str = "max"):
        super().__init__()
        self.kernel_size, self.repeats = kernel_size, repeats
        self.pool = {"max": max_pool_torch, "avg": avg_pool_torch}[pool]

    def forward(self, x: Tensor) -> Tensor:
        pad, outputs = (self.kernel_size - 1) // 2, []
        for _ in range(self.repeats):
            x = self.pool(x, self.kernel_size, 1, pad)
            outputs.append(x)
        return torch.cat(outputs, dim=-1)


class ESEBlock(nn.Module):
    """Effective Squeeze-Excitation (VoVNet): global average pool → 1×1 conv
    ``linear`` → hard-sigmoid gate, on NHWC tensors."""

    def __init__(self, channels: int, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        self.linear = Conv2d(channels, channels, 1, dtype=dtype, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        return x * hard_sigmoid(self.linear(x.mean((1, 2), keepdim=True)))


class SqueezeExcitation(nn.Module):
    """torchvision-style SE block on NHWC tensors: global average pool →
    1×1 ``fc1`` → ``act`` → 1×1 ``fc2`` → ``gate`` ("sigmoid", else the hard
    sigmoid, as in the JAX module). The defaults relu/sigmoid are
    PatchConvNet's and RegNetY's; MobileNetV3 uses relu/hardsigmoid,
    EfficientNet silu/sigmoid."""

    def __init__(self, channels: int, squeeze_channels: int, act: str = "relu",
                 gate: str = "sigmoid", *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        self.fc1 = Conv2d(channels, squeeze_channels, 1, dtype=dtype, generator=generator)
        self.fc2 = Conv2d(squeeze_channels, channels, 1, dtype=dtype, generator=generator)
        self.act = ACTIVATIONS[act]
        self.gate = torch.sigmoid if gate == "sigmoid" else hard_sigmoid

    def forward(self, x: Tensor) -> Tensor:
        s = self.fc2(self.act(self.fc1(x.mean((1, 2), keepdim=True))))
        return x * self.gate(s)


class DeformableConv2d(nn.Module):
    """DCN v1/v2 on NHWC tensors: a ``conv_offset`` conv (2k² channels: Δy,
    Δx per tap), with ``v2`` a sigmoid ``conv_mask`` conv (k²), and the
    deformable sampling ``ops/deform_conv.deform_conv2d`` with ``weight``
    (out, in, k, k) (the bridge's layout of the JAX module's (k, k, in, out)
    ``kernel``) and an optional ``bias``. The offset and mask convs run in
    ``dtype``; the sampling in x's type, its products promoted with the f32
    weight, as in the JAX module."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True, v2: bool = True, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        conv = dict(stride=stride, padding=padding, dilation=dilation, dtype=dtype,
                    generator=generator)
        self.conv_offset = Conv2d(in_channels, 2 * k * k, k, **conv)
        self.conv_mask = Conv2d(in_channels, k * k, k, **conv) if v2 else None
        self.weight = nn.Parameter(torch_default_kernel((out_channels, in_channels, k, k),
                                                        generator))
        self.bias = (nn.Parameter(torch_default_bias(in_channels * k * k)((out_channels,),
                                                                          generator))
                     if bias else None)

    def forward(self, x: Tensor) -> Tensor:
        offset = self.conv_offset(x)
        mask = None if self.conv_mask is None else torch.sigmoid(self.conv_mask(x))
        return deform_conv2d(x, self.weight, offset, mask, self.bias, stride=self.stride,
                             padding=self.padding, dilation=self.dilation)
