"""DeiT and DeiT3 — port of ``vision_toolbox_tpu/models/deit.py``.

DeiT adds a distillation token: the PE is added to the patch tokens before
the cls and dist tokens are put in front, and the pooled output is the mean
of the (cls, dist) pair after the final norm. DeiT3 is a plain ViT with
LayerScale init 1e-6, so its blocks run the γ_ls branch of the fused
kernels. ``forward(force_unfused=True)``, and a model built with dropout,
keep the blocks on the module chain, whose attention runs the
short-attention kernel K2 (``ViT.forward``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor, nn

from ..nn.layers import as_dtype
from .base import register_model, to_device
from .vit import VIT_VARIANTS, ViT


class DeiT(ViT):
    """ViT with a cls and a distillation token, pooled as their mean."""

    def __init__(self, *args: Any, device: torch.device | str = "cuda", **kwargs: Any):
        super().__init__(*args, device="cpu", **kwargs)
        self.dist_token = nn.Parameter(torch.zeros(1, 1, self.d_model))
        to_device(self, device)

    def _tokens(self, x: Tensor) -> Tensor:
        out = self._embed(x)
        B = out.shape[0]
        cls, dist = (as_dtype(t, out.dtype).expand(B, -1, -1)
                     for t in (self.cls_token, self.dist_token))
        return torch.cat([cls, dist, out], dim=1)

    def forward(self, x: Tensor, train: bool = False, *, force_unfused: bool = False,
                plain: bool = False, generator: torch.Generator | None = None) -> Tensor:
        out = self._tokens(x)
        for block in self.blocks:
            out = block(out, train, force_unfused=force_unfused, plain=plain, generator=generator)
        return self.norm(out[:, :2]).mean(dim=1)


def deit_from_config(variant: str, img_size: int = 224, **kwargs: Any) -> DeiT:
    name, patch_size = variant.split("_")
    d_model, depth, n_heads = VIT_VARIANTS[name]
    return DeiT(d_model=d_model, depth=depth, n_heads=n_heads, patch_size=int(patch_size),
                img_size=img_size, **kwargs)


def deit3_from_config(variant: str, img_size: int = 224, **kwargs: Any) -> ViT:
    name, patch_size = variant.split("_")
    d_model, depth, n_heads = VIT_VARIANTS[name]
    kwargs.setdefault("layer_scale_init", 1e-6)
    return ViT(d_model=d_model, depth=depth, n_heads=n_heads, patch_size=int(patch_size),
               img_size=img_size, **kwargs)


for _v in ("Ti_16", "S_16", "B_16", "L_16", "H_14"):
    register_model(f"deit_{_v.lower()}")(
        lambda variant=_v, img_size=224, **kw: deit_from_config(variant, img_size, **kw)
    )
    register_model(f"deit3_{_v.lower()}")(
        lambda variant=_v, img_size=224, **kw: deit3_from_config(variant, img_size, **kw)
    )
