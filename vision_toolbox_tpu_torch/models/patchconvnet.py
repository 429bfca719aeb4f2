"""PatchConvNet — port of ``vision_toolbox_tpu/models/patchconvnet.py``.

NHWC throughout, as in the JAX package. The stem is four 3×3 stride-2
convs without bias (``Conv2d``, cuDNN, as XLA runs them in the JAX package),
GELU after the first three. Each trunk block is norm (flax's BatchNorm,
``LinenBatchNorm``, or LayerNorm with ε 1e-6 for ``norm_type="ln"``) →
``mix1`` → GELU → 3×3 depthwise conv with bias (``DepthwiseConv``: the K9
kernels on the card) → GELU → ``SqueezeExcitation`` (d/4) → ``mix2`` →
``layer_scale`` → drop-path (the same rate in every block) → residual. The
head is ``AttentionPooling``: a class token attends over the tokens through
one head of width d, with ``jax.nn.dot_product_attention``'s rounding
(``ops/short_attention.dense_attention``, which the JAX package calls
directly here), then LayerScale, drop-path, a plain MLP (3d) and a last
LayerNorm on the class token. ``get_feature_maps`` returns ``[pooled]``.

Parameters are drawn in float32 from an explicit ``torch.Generator`` (seed
0 when none is given) with the JAX package's inits (truncated normal 0.02,
zero biases; the SE convs PyTorch's default) and moved to ``device``, the
card unless the caller asks for another; ``dtype`` is the compute type.
Module names follow the JAX tree (``stem_<i>``, ``norm``, ``mix1``,
``dwconv``, ``se/fc{1,2}``, ``mix2``, ``layer_scale``, ``pool`` with
``cls_token``, ``norm{1,2,3}``, ``{q,k,v,out}_proj``, ``layer_scale_{1,2}``,
``mlp``); its ``block_<i>`` are ``blocks.<i>`` here.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor, nn

from ..nn.attention import MLP
from ..nn.initializers import trunc_normal
from ..nn.layers import (
    Conv2d, DepthwiseConv, LayerNorm, Linear, SqueezeExcitation, StochasticDepth, _gelu_exact,
    as_dtype,
)
from ..nn.norm import LinenBatchNorm
from ..ops.short_attention import dense_attention
from .base import Backbone, register_model, to_device


def _zeros(shape, generator):
    return torch.zeros(shape)


def _linear(d_in: int, d_out: int, dtype, generator) -> Linear:
    return Linear(d_in, d_out, kernel_init=trunc_normal(0.02), bias_init=_zeros, dtype=dtype,
                  generator=generator)


class PatchConvBlock(nn.Module):
    """Trunk block, BatchNorm (``norm_type="bn"``) or LayerNorm (``"ln"``)."""

    def __init__(self, embed_dim: int, drop_path: float = 0.3, layer_scale_init: float = 1e-6,
                 norm_type: str = "bn", *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        d = embed_dim
        self.norm = (LinenBatchNorm(d, momentum=0.9, eps=1e-5, dtype=dtype) if norm_type == "bn"
                     else LayerNorm(d, 1e-6))
        self.mix1 = _linear(d, d, dtype, generator)
        self.dwconv = DepthwiseConv(d, 3, kernel_init=trunc_normal(0.02), bias_init=_zeros,
                                    dtype=dtype, generator=generator)
        self.se = SqueezeExcitation(d, d // 4, dtype=dtype, generator=generator)
        self.mix2 = _linear(d, d, dtype, generator)
        self.layer_scale = nn.Parameter(torch.full((d,), float(layer_scale_init)))
        self.droppath = StochasticDepth(drop_path)

    def forward(self, x: Tensor, train: bool = False, *, plain: bool = False,
                generator: torch.Generator | None = None) -> Tensor:
        """``plain`` runs the depthwise conv's plain versions on any device."""
        y = self.norm(x, train) if isinstance(self.norm, LinenBatchNorm) else self.norm(x)
        y = _gelu_exact(self.mix1(y))
        y = _gelu_exact(self.dwconv(y, plain=plain))
        y = self.mix2(self.se(y))
        y = y * as_dtype(self.layer_scale, y.dtype)
        return x + self.droppath(y, train=train, generator=generator)


class AttentionPooling(nn.Module):
    """Single-head attention pooling with a class token."""

    def __init__(self, embed_dim: int, mlp_ratio: int = 3, drop_path: float = 0.3,
                 layer_scale_init: float = 1e-6, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        d = embed_dim
        self.cls_token = nn.Parameter(trunc_normal(0.02)((d,), generator))
        self.norm1 = LayerNorm(d, 1e-5)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, _linear(d, d, dtype, generator))
        self.layer_scale_1 = nn.Parameter(torch.full((d,), float(layer_scale_init)))
        self.droppath1 = StochasticDepth(drop_path)
        self.norm2 = LayerNorm(d, 1e-5)
        self.mlp = MLP(d, int(d * mlp_ratio), dtype=dtype, generator=generator)
        self.layer_scale_2 = nn.Parameter(torch.full((d,), float(layer_scale_init)))
        self.droppath2 = StochasticDepth(drop_path)
        self.norm3 = LayerNorm(d, 1e-5)

    def forward(self, x: Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> Tensor:
        """x: (B, T, d) tokens → (B, d)."""
        B, _, d = x.shape
        cls = as_dtype(self.cls_token, x.dtype).expand(B, 1, d)
        y = self.norm1(torch.cat([cls, x], dim=1))
        q = self.q_proj(y[:, :1])
        out = dense_attention(q[:, :, None], self.k_proj(y)[:, :, None],
                              self.v_proj(y)[:, :, None])[:, :, 0]
        out = self.out_proj(out)
        out = out * as_dtype(self.layer_scale_1, out.dtype)
        cls = cls + self.droppath1(out, train=train, generator=generator)
        y = self.mlp(self.norm2(cls), train=train, generator=generator)
        y = y * as_dtype(self.layer_scale_2, y.dtype)
        cls = cls + self.droppath2(y, train=train, generator=generator)
        return self.norm3(cls)[:, 0]


class PatchConvNet(Backbone):
    def __init__(self, embed_dim: int, depth: int, mlp_ratio: int = 3, drop_path: float = 0.3,
                 layer_scale_init: float = 1e-6, norm_type: str = "bn", *,
                 dtype: torch.dtype | None = None, device: torch.device | str = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        d = self.embed_dim = embed_dim
        self.compute_dtype = torch.float32 if dtype is None else dtype
        chans = (3, d // 8, d // 4, d // 2, d)
        for i in range(4):
            setattr(self, f"stem_{i}", Conv2d(chans[i], chans[i + 1], 3, 2, 1, use_bias=False,
                                              kernel_init=trunc_normal(0.02), dtype=dtype,
                                              generator=gen))
        self.blocks = nn.ModuleList(
            PatchConvBlock(d, drop_path, layer_scale_init, norm_type, dtype=dtype, generator=gen)
            for _ in range(depth))
        self.pool = AttentionPooling(d, mlp_ratio, drop_path, layer_scale_init, dtype=dtype,
                                     generator=gen)
        to_device(self, device)

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        return (self.embed_dim,)

    @property
    def stride(self) -> int:
        return 16

    def get_feature_maps(self, x: Tensor, train: bool = False, *, plain: bool = False,
                         generator: torch.Generator | None = None) -> list[Tensor]:
        """x: (B, H, W, 3) NHWC → [(B, d) pooled features]. ``plain`` runs the
        depthwise convs' plain versions (for checking the kernels)."""
        for i in range(4):
            x = getattr(self, f"stem_{i}")(x)
            if i < 3:
                x = _gelu_exact(x)
        for block in self.blocks:
            x = block(x, train, plain=plain, generator=generator)
        return [self.pool(x.reshape(x.shape[0], -1, self.embed_dim), train, generator)]

    def forward(self, x: Tensor, train: bool = False, generator: torch.Generator | None = None,
                *, plain: bool = False) -> Tensor:
        """(B, d) pooled features. ``plain`` runs the kernels' plain versions."""
        return self.get_feature_maps(x, train, plain=plain, generator=generator)[-1]


PATCHCONVNET_WIDTHS = {"S": 384, "B": 768, "L": 1024}


def patchconvnet_from_config(variant: str, depth: int = 60, **kwargs: Any) -> PatchConvNet:
    return PatchConvNet(embed_dim=PATCHCONVNET_WIDTHS[variant], depth=depth, **kwargs)


for _v in PATCHCONVNET_WIDTHS:
    register_model(f"patchconvnet_{_v.lower()}")(
        lambda variant=_v, depth=60, **kw: patchconvnet_from_config(variant, depth, **kw))
