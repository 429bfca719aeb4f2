"""ConvNeXt v1 and v2 — port of ``vision_toolbox_tpu/models/convnext.py``.

NHWC throughout, as in the JAX package. A block is a 7×7 depthwise conv
(``DepthwiseConv``: the K9 kernels on the card), then LayerNorm → pwconv1 →
GELU → (v2: ``GlobalResponseNorm``) → pwconv2 → (v1: LayerScale) →
drop-path, added to the block input. In v1 that second half is the fused MLP
half-block (``nn/attention.fused_mlp_halfblock``, the K3 kernels on the
card) with the block input as its separate residual, wherever K3's shape
rule admits the width (multiples of 32: every stage of convnext_t/s/b/l/xl/h;
convnext_a's 40- and 80-wide stages run the modules); v2 runs its modules,
since GRN sits between GELU and pwconv2, as the JAX package does. The stem
(4×4 stride 4) and the downsampling convs (2×2 stride 2) are ``Conv2d``
(cuDNN, as XLA runs them in the JAX package). Stochastic-depth rates rise
linearly over all blocks; ``get_feature_maps`` returns all four stages and
``forward`` the normalised global average of the last.

Parameters are drawn in float32 from an explicit ``torch.Generator`` (seed
0 when none is given) and moved to ``device``, the card unless the caller
asks for another; ``dtype`` is the compute type they are rounded to at use.
Module names follow the JAX tree (``stem_conv``, ``stem_norm``,
``downsample_norm_<i>``, ``downsample_conv_<i>``, ``dwconv``, ``norm``,
``pwconv1``, ``pwconv2``, ``layer_scale``, ``grn``); its
``stage_<i>_block_<j>`` are ``stages.<i>.<j>`` here.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor, nn

from ..nn.attention import fused_mlp_halfblock
from ..nn.initializers import torch_default_bias
from ..nn.layers import (
    Conv2d, DepthwiseConv, LayerNorm, LayerScale, Linear, StochasticDepth, _gelu_exact, as_dtype,
)
from ..ops import block_mlp
from .base import Backbone, register_model, to_device


class GlobalResponseNorm(nn.Module):
    """ConvNeXt v2's GRN on NHWC: x + x·N(x)·γ + β with N the per-channel
    spatial L2 norm over its mean across channels, in the input type."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: Tensor) -> Tensor:
        gx = torch.sqrt(torch.square(x).sum((1, 2), keepdim=True))  # (B, 1, 1, C)
        nx = gx / (gx.mean(-1, keepdim=True) + self.eps)
        return x + x * nx * as_dtype(self.gamma, x.dtype) + as_dtype(self.beta, x.dtype)


class ConvNeXtBlock(nn.Module):
    def __init__(self, d_model: int, expansion_ratio: float = 4.0, bias: bool = True,
                 layer_scale_init: float | None = 1e-6, stochastic_depth: float = 0.0,
                 norm_eps: float = 1e-6, v2: bool = False, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        hidden = int(d_model * expansion_ratio)
        ls = None if v2 else layer_scale_init
        self.dwconv = DepthwiseConv(d_model, 7, bias, bias_init=torch_default_bias(49),
                                    dtype=dtype, generator=generator)
        self.norm = LayerNorm(d_model, norm_eps)
        self.pwconv1 = Linear(d_model, hidden, bias, dtype=dtype, generator=generator)
        self.grn = GlobalResponseNorm(hidden) if v2 else None
        self.pwconv2 = Linear(hidden, d_model, bias, dtype=dtype, generator=generator)
        self.layer_scale = LayerScale(d_model, ls) if ls is not None else None
        self.droppath = StochasticDepth(stochastic_depth)
        self.fusable = not v2 and bias  # the fused half has no GRN and takes the biases

    def fused_at(self, t: int) -> bool:
        """Whether the MLP half runs the fused kernel on maps of ``t`` tokens."""
        hidden, d_model = self.pwconv1.weight.shape
        return self.fusable and block_mlp.use_fused_mlp(d_model, hidden, t, 0.0, has_res=True,
                                                        has_ls=self.layer_scale is not None)

    def forward(self, x: Tensor, train: bool = False, *, force_unfused: bool = False,
                plain: bool = False, generator: torch.Generator | None = None) -> Tensor:
        """``force_unfused`` keeps the MLP half on the module chain; ``plain``
        runs the kernels' plain versions on any device."""
        y = self.dwconv(x, plain=plain)
        B, H, W, C = y.shape
        if not force_unfused and self.fused_at(H * W):
            out = fused_mlp_halfblock(
                y.reshape(B, H * W, C), self.norm, self.pwconv1, self.pwconv2, self.layer_scale,
                self.droppath, residual=x.reshape(B, H * W, C), train=train, plain=plain,
                generator=generator,
            )
            return out.reshape(B, H, W, C)
        y = _gelu_exact(self.pwconv1(self.norm(y)))
        if self.grn is not None:
            y = self.grn(y)
        y = self.pwconv2(y)
        if self.layer_scale is not None:
            y = self.layer_scale(y)
        return x + self.droppath(y, train=train, generator=generator)


class ConvNeXt(Backbone):
    def __init__(
        self, d_model: int, depths: tuple[int, ...], expansion_ratio: float = 4.0,
        bias: bool = True, layer_scale_init: float | None = 1e-6, stochastic_depth: float = 0.0,
        norm_eps: float = 1e-6, v2: bool = False, *, dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda", generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.d_model, self.depths = d_model, tuple(depths)
        self.compute_dtype = torch.float32 if dtype is None else dtype
        self.stem_conv = Conv2d(3, d_model, 4, 4, dtype=dtype, generator=gen)
        self.stem_norm = LayerNorm(d_model, norm_eps)
        rates = torch.linspace(0, stochastic_depth, sum(self.depths), dtype=torch.float64,
                               device="cpu").tolist()
        d, self.stages = d_model, nn.ModuleList()
        for i, depth in enumerate(self.depths):
            if i > 0:
                setattr(self, f"downsample_norm_{i}", LayerNorm(d, norm_eps))
                setattr(self, f"downsample_conv_{i}", Conv2d(d, 2 * d, 2, 2, dtype=dtype,
                                                             generator=gen))
                d *= 2
            first = sum(self.depths[:i])
            self.stages.append(nn.ModuleList(
                ConvNeXtBlock(d, expansion_ratio, bias, layer_scale_init, rates[first + j],
                              norm_eps, v2, dtype=dtype, generator=gen)
                for j in range(depth)))
        self.norm = LayerNorm(d, norm_eps)
        to_device(self, device)

    def get_feature_maps(self, x: Tensor, train: bool = False, *, force_unfused: bool = False,
                         plain: bool = False,
                         generator: torch.Generator | None = None) -> list[Tensor]:
        """x: (B, H, W, 3) NHWC → the four stages' NHWC outputs."""
        x = self.stem_norm(self.stem_conv(x))
        outputs = []
        for i, blocks in enumerate(self.stages):
            if i > 0:
                x = getattr(self, f"downsample_conv_{i}")(getattr(self, f"downsample_norm_{i}")(x))
            for block in blocks:
                x = block(x, train, force_unfused=force_unfused, plain=plain, generator=generator)
            outputs.append(x)
        return outputs

    def forward(self, x: Tensor, train: bool = False, generator: torch.Generator | None = None, *,
                force_unfused: bool = False, plain: bool = False) -> Tensor:
        """(B, C) features: the normalised global average of the last stage.
        ``force_unfused`` keeps the MLP halves on the module chain; ``plain``
        runs the kernels' plain versions (for checking them on the card)."""
        out = self.get_feature_maps(x, train, force_unfused=force_unfused, plain=plain,
                                    generator=generator)[-1]
        return self.norm(out.mean((1, 2)))

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        return tuple(self.d_model * 2**i for i in range(len(self.depths)))

    @property
    def stride(self) -> int:
        return 4 * 2 ** (len(self.depths) - 1)


CONVNEXT_VARIANTS = {  # width, depths (vision_toolbox_tpu/models/convnext.py)
    "A": (40, (2, 2, 6, 2)),
    "F": (48, (2, 2, 6, 2)),
    "P": (64, (2, 2, 6, 2)),
    "N": (80, (2, 2, 8, 2)),
    "T": (96, (3, 3, 9, 3)),
    "S": (96, (3, 3, 27, 3)),
    "B": (128, (3, 3, 27, 3)),
    "L": (192, (3, 3, 27, 3)),
    "XL": (256, (3, 3, 27, 3)),
    "H": (352, (3, 3, 27, 3)),
}


def convnext_from_config(variant: str, v2: bool = False, **kwargs: Any) -> ConvNeXt:
    d_model, depths = CONVNEXT_VARIANTS[variant]
    return ConvNeXt(d_model=d_model, depths=depths, v2=v2, **kwargs)


for _v in CONVNEXT_VARIANTS:
    register_model(f"convnext_{_v.lower()}")(
        lambda variant=_v, **kw: convnext_from_config(variant, v2=False, **kw))
    register_model(f"convnextv2_{_v.lower()}")(
        lambda variant=_v, **kw: convnext_from_config(variant, v2=True, **kw))
