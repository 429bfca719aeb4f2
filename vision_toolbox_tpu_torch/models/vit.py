"""ViT with cls-token, GAP and MAP (SigLIP) pooling — port of
``vision_toolbox_tpu/models/vit.py``.

Images are NHWC, as in the JAX package. Parameters are drawn on the CPU in
float32 from an explicit ``torch.Generator`` (seed 0 when none is given),
then moved to ``device`` — the card unless the caller asks for another —
and stay float32, as flax keeps them. ``dtype`` is the compute type of the
whole model (bf16 for training and serving): weights, biases, the patch
embedding, PE and tokens are rounded to it at use, where flax's
``promote_dtype`` rounds them, and LayerNorms apply theirs in f32.
``resize_pe`` carries a position table to another image size (a 224 px
table to a 512 px SigLIP model, T = 1024, whose attention runs the flash
kernel). Not ported yet: ``token_sharding`` (sequence parallelism).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..nn.attention import MHAPooling, ViTBlock
from ..nn.initializers import normal, torch_default_bias, torch_default_kernel
from ..nn.layers import LayerNorm, as_dtype
from .base import Backbone, register_model, to_device

POOL_TYPES = ("cls_token", "gap", "mha")


class PatchEmbed(nn.Module):
    """Strided p×p conv, NHWC image → (B, H/p · W/p, D) tokens in row-major
    patch order (the JAX package's conv + reshape)."""

    def __init__(self, d_model: int, patch_size: int, *, generator: torch.Generator):
        super().__init__()
        p = patch_size
        self.patch_size = p
        self.weight = nn.Parameter(torch_default_kernel((d_model, 3, p, p), generator))
        self.bias = nn.Parameter(torch_default_bias(3 * p * p)((d_model,), generator))

    def forward(self, x: Tensor) -> Tensor:
        """Computes in ``x.dtype``."""
        x = F.conv2d(x.permute(0, 3, 1, 2), as_dtype(self.weight, x.dtype),
                     as_dtype(self.bias, x.dtype), stride=self.patch_size)
        return x.flatten(2).transpose(1, 2)


class ViT(Backbone):
    def __init__(
        self, d_model: int, depth: int, n_heads: int, patch_size: int, img_size: int,
        cls_token: bool = True, pool_type: str = "cls_token", bias: bool = True,
        mlp_ratio: float = 4.0, dropout: float = 0.0, layer_scale_init: float | None = None,
        stochastic_depth: float = 0.0, norm_eps: float = 1e-6, *,
        dtype: torch.dtype | None = None, device: torch.device | str = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if pool_type not in POOL_TYPES:
            raise ValueError(f"unsupported pool_type {pool_type}")
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.d_model, self.patch_size, self.img_size = d_model, patch_size, img_size
        self.pool_type = pool_type
        self.compute_dtype = torch.float32 if dtype is None else dtype

        self.patch_embed = PatchEmbed(d_model, patch_size, generator=gen)
        n_tokens = (img_size // patch_size) ** 2
        self.pe = nn.Parameter(normal(0.02)((1, n_tokens, d_model), gen))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model)) if cls_token else None
        self.blocks = nn.ModuleList(
            ViTBlock(d_model, n_heads, bias, mlp_ratio, dropout, layer_scale_init,
                     stochastic_depth, norm_eps, dtype=dtype, generator=gen)
            for _ in range(depth)
        )
        self.norm = LayerNorm(d_model, norm_eps)
        self.pooler = (
            MHAPooling(d_model, n_heads, bias, mlp_ratio, norm_eps, dtype=dtype, generator=gen)
            if pool_type == "mha" else None
        )
        to_device(self, device)

    def _embed(self, x: Tensor) -> Tensor:
        """NHWC image → (B, H·W, D) tokens + learned PE, in the compute type."""
        dt = self.compute_dtype
        return self.patch_embed(as_dtype(x, dt)) + as_dtype(self.pe, dt)

    def _tokens(self, x: Tensor) -> Tensor:
        """Embedded tokens with the cls token in front, if any."""
        out = self._embed(x)
        if self.cls_token is None:
            return out
        cls = as_dtype(self.cls_token, out.dtype).expand(out.shape[0], -1, -1)
        return torch.cat([cls, out], dim=1)

    def forward(self, x: Tensor, train: bool = False, *, force_unfused: bool = False,
                plain: bool = False, generator: torch.Generator | None = None) -> Tensor:
        """x: (B, H, W, 3) → (B, D) pooled features. ``force_unfused`` keeps
        every block on the plain module chain (the chain the JAX package
        runs under token sharding, and a model with dropout takes anyway),
        whose attention runs the short-attention kernel K2 from batch 6 of
        vit_b_16; ``plain`` runs the fused half-blocks and the attention
        kernels through their plain PyTorch versions instead of the kernels
        (for checking the kernels on the card); ``generator`` feeds dropout
        and stochastic depth in training."""
        out = self._tokens(x)
        for block in self.blocks:
            out = block(out, train, force_unfused=force_unfused, plain=plain, generator=generator)
        if self.pool_type == "cls_token":
            return self.norm(out[:, 0])
        if self.pool_type == "gap":
            return self.norm(out).mean(dim=1)
        return self.pooler(self.norm(out), train=train, generator=generator)

    @property
    def last_out_channels(self) -> int:
        return self.d_model


VIT_VARIANTS = {
    "Ti": (192, 12, 3),
    "S": (384, 12, 6),
    "M": (512, 12, 8),
    "B": (768, 12, 12),
    "L": (1024, 24, 16),
    "H": (1280, 32, 16),
}


def _keys_cubic(x: Tensor) -> Tensor:
    """Keys' cubic convolution kernel, a = −0.5 (jax.image's "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int) -> Tensor:
    """(n_in, n_out) f32 weights of ``jax.image.resize`` along one axis
    (``compute_weight_mat``): half-pixel centres, the kernel widened by
    n_in/n_out when shrinking (antialiasing), each output's weights divided
    by their sum (so they renormalise at the edges)."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = _keys_cubic(x / max(inv_scale, 1.0))
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_pe(pe: Tensor, new_img_size: int, patch_size: int, method: str = "bicubic") -> Tensor:
    """Functional position-embedding resize, what the JAX package's
    ``resize_pe`` computes with ``jax.image.resize``: ``pe`` (1, N, C), a
    square grid of tokens, interpolated to the (new_img_size / patch_size)²
    grid, one 1-D weight matrix per axis applied in f32 (``method``:
    "bicubic", Keys with a = −0.5, the only one ported). Returns (1, N', C)
    in pe's type. ``torch.nn.functional.interpolate`` differs: its bicubic
    uses a = −0.75 and never antialiases."""
    if method not in ("bicubic", "cubic"):
        raise ValueError(f"resize_pe: method {method!r} is not ported; use 'bicubic'")
    old = int(round(pe.shape[1] ** 0.5))
    new = new_img_size // patch_size
    grid = pe.reshape(old, old, -1).float()
    if new != old:
        w = _resize_weights(old, new).to(pe.device)
        grid = torch.einsum("ia,jb,ijc->abc", w, w, grid)
    return grid.reshape(1, new * new, -1).to(pe.dtype)


def vit_from_config(variant: str, img_size: int = 224, *, weights: str | None = None,
                    **kwargs: Any) -> ViT:
    """``variant`` like "B_16". ``weights='siglip'`` switches to MAP pooling
    without a cls token."""
    name, patch_size = variant.split("_")
    d_model, depth, n_heads = VIT_VARIANTS[name]
    if weights == "siglip":
        kwargs.setdefault("cls_token", False)
        kwargs.setdefault("pool_type", "mha")
    return ViT(d_model=d_model, depth=depth, n_heads=n_heads, patch_size=int(patch_size),
               img_size=img_size, **kwargs)


for _v in ("Ti_16", "S_32", "S_16", "M_16", "B_32", "B_16", "L_16", "H_14"):
    register_model(f"vit_{_v.lower()}")(
        lambda variant=_v, img_size=224, **kw: vit_from_config(variant, img_size, **kw)
    )
