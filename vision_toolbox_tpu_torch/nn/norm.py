"""BatchNorm — port of ``vision_toolbox_tpu/nn/norm.py``, in plain PyTorch,
and ``LinenBatchNorm``, flax's own ``nn.BatchNorm`` (PatchConvNet's).

Statistics in float32, applied in the compute dtype:

- batch mean μ and mean of squares E[x²] over every axis but the channels,
  in f32; fast variance ``max(E[x²] − μ², 0)``;
- folded into a per-channel scale and shift ``a = γ·rsqrt(var + ε)``,
  ``b = β − μ·a``, applied as ``x·a + b`` with ``a`` and ``b`` cast to
  ``x``'s dtype (bf16 on the training path), as inference-folded BN;
- running stats with flax's momentum convention ``ra = m·ra + (1 − m)·batch``
  (m = 0.9 is torch's 0.1), the running variance from the unbiased batch
  variance, ε = 1e-5.

``F.batch_norm`` and cuDNN normalise in f32 and round elsewhere, so they do
not give these numbers. Input is NHWC (channels last) in the compute dtype
the conv produced; ``weight`` is flax's ``scale``.
"""

from __future__ import annotations

import torch
from torch import Tensor, nn


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        if train:
            dims = tuple(range(x.ndim - 1))
            xf = x.float()
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                n = x.numel() // x.shape[-1]
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        return x * a.to(x.dtype) + b.to(x.dtype)


class LinenBatchNorm(nn.Module):
    """flax ``linen.BatchNorm`` (``use_fast_variance``, f32 reductions), which
    PatchConvNet's blocks use in the JAX package instead of the folded
    ``BatchNorm`` above: statistics of x in f32 with the fast variance
    ``max(E[x²] − μ², 0)``; ``(x − μ)·(rsqrt(var + ε)·γ) + β`` in f32, cast to
    ``dtype`` (else x's type promoted with f32's); running statistics
    ``ra = m·ra + (1 − m)·batch`` with the biased batch variance."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        xf = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))
