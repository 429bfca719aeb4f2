"""Core NN primitives — port of ``vision_toolbox_tpu/nn/layers.py``, the part
the transformer path uses: ``Linear``, ``LayerNorm`` (flax semantics),
``LayerScale``, ``StochasticDepth`` and the exact-erf GELU. The conv layers
come with the convnet slice.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .initializers import torch_default_bias, torch_default_kernel


def _gelu_exact(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="none")


ACTIVATIONS: dict[str, Callable | None] = {
    "none": None,
    "gelu": _gelu_exact,  # torch nn.GELU default is exact erf, not tanh approx
}


class Linear(nn.Module):
    """nn.Linear with PyTorch's default init drawn from an explicit generator.
    ``weight`` is (out_features, in_features)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch_default_kernel((out_features, in_features), generator))
        self.bias = (
            nn.Parameter(torch_default_bias(in_features)((out_features,), generator))
            if use_bias else None
        )

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x, self.weight, self.bias)


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

    def sample_scale(self, batch: int, train: bool = False, *, device=None) -> Tensor | None:
        """(batch, 1) f32 mask/keep_p scale for the fused kernels, or None
        when this is an identity."""
        if not train or self.p == 0.0:
            return None
        keep_p = 1.0 - self.p
        mask = torch.rand((batch, 1), device=device) < keep_p
        return mask.float() / keep_p

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        scale = self.sample_scale(x.shape[0], train, device=x.device)
        if scale is None:
            return x
        return x * scale.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)


class LayerScale(nn.Module):
    """Learnable per-channel γ multiplier."""

    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x: Tensor) -> Tensor:
        return x * self.gamma
