"""MLP-Mixer — port of ``vision_toolbox_tpu/models/mlp_mixer.py``.

A p×p stride-p conv embeds the NHWC image as (B, N, d) tokens; each
``MixerBlock`` mixes tokens (LayerNorm over d, then the plain ``MLP`` over
N on the (B, d, N) transpose, ``torch.matmul`` as XLA runs it in the JAX
package, then the residual) and channels. The channel half is the
transformer's MLP half-block, so it runs the fused MLP op
(``nn/attention.fused_mlp_halfblock``: the K3 kernels on the card) wherever
``use_fused_mlp(d, 4d, N, dropout)`` admits it, with no LayerScale and no
drop-path, as the JAX block calls it; else the module chain. ``forward``
returns the final LayerNorm's mean over the tokens, (B, d).

Parameters are drawn in float32 from an explicit ``torch.Generator`` (seed
0 when none is given) and moved to ``device``, the card unless the caller
asks for another; ``dtype`` is the compute type. Module names follow the
JAX tree (``patch_embed``, ``norm1``, ``token_mixing``, ``norm2``,
``channel_mixing``, ``norm``); its ``block_<i>`` are ``blocks.<i>`` here.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor, nn

from ..nn.attention import MLP, float_linears, fused_mlp_halfblock
from ..nn.layers import Conv2d, LayerNorm
from ..ops import block_mlp
from .base import Backbone, register_model, to_device


class MixerBlock(nn.Module):
    def __init__(self, n_tokens: int, d_model: int, mlp_ratio: tuple[float, float] = (0.5, 4.0),
                 dropout: float = 0.0, norm_eps: float = 1e-6, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        self.d_model, self.dropout = d_model, dropout
        self.hidden = int(d_model * mlp_ratio[1])
        kw = dict(dtype=dtype, generator=generator)
        self.norm1 = LayerNorm(d_model, norm_eps)
        self.token_mixing = MLP(n_tokens, int(d_model * mlp_ratio[0]), dropout, **kw)
        self.norm2 = LayerNorm(d_model, norm_eps)
        self.channel_mixing = MLP(d_model, self.hidden, dropout, **kw)

    def fused_at(self, t: int) -> bool:
        """Whether the channel half runs the fused kernel on ``t`` tokens."""
        return (float_linears(self.channel_mixing.linear1, self.channel_mixing.linear2)
                and block_mlp.use_fused_mlp(self.d_model, self.hidden, t, self.dropout))

    def forward(self, x: Tensor, train: bool = False, *, force_unfused: bool = False,
                plain: bool = False, generator: torch.Generator | None = None) -> Tensor:
        """``force_unfused`` keeps the channel half on the module chain;
        ``plain`` runs the fused op's plain versions on any device."""
        y = self.norm1(x).transpose(1, 2)  # (B, d, N)
        x = x + self.token_mixing(y, train, generator).transpose(1, 2)
        if not force_unfused and self.fused_at(x.shape[1]):
            return fused_mlp_halfblock(x, self.norm2, self.channel_mixing.linear1,
                                       self.channel_mixing.linear2, None, None, train=train,
                                       plain=plain)
        return x + self.channel_mixing(self.norm2(x), train, generator)


class MLPMixer(Backbone):
    """The JAX class's surface: ``forward`` → (B, d), ``last_out_channels``;
    no feature maps."""

    def __init__(self, n_layers: int, d_model: int, patch_size: int, img_size: int,
                 mlp_ratio: tuple[float, float] = (0.5, 4.0), dropout: float = 0.0,
                 norm_eps: float = 1e-6, *, dtype: torch.dtype | None = None,
                 device: torch.device | str = "cuda", generator: torch.Generator | None = None):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.d_model, self.patch_size, self.img_size = d_model, patch_size, img_size
        self.compute_dtype = torch.float32 if dtype is None else dtype
        p = patch_size
        self.patch_embed = Conv2d(3, d_model, p, p, dtype=dtype, generator=gen)
        n_tokens = (img_size // p) ** 2
        self.blocks = nn.ModuleList(
            MixerBlock(n_tokens, d_model, mlp_ratio, dropout, norm_eps, dtype=dtype,
                       generator=gen)
            for _ in range(n_layers))
        self.norm = LayerNorm(d_model, norm_eps)
        to_device(self, device)

    def forward(self, x: Tensor, train: bool = False, generator: torch.Generator | None = None,
                *, force_unfused: bool = False, plain: bool = False) -> Tensor:
        """(B, H, W, 3) NHWC → (B, d). ``force_unfused`` keeps the channel
        halves on the module chain; ``plain`` runs the fused op's plain
        versions (for checking the kernels)."""
        x = self.patch_embed(x)
        x = x.reshape(x.shape[0], -1, self.d_model)
        for block in self.blocks:
            x = block(x, train, force_unfused=force_unfused, plain=plain, generator=generator)
        return self.norm(x).mean(1)

    @property
    def last_out_channels(self) -> int:
        return self.d_model


MIXER_VARIANTS = {"S": (8, 512), "B": (12, 768), "L": (24, 1024), "H": (32, 1280)}


def mlp_mixer_from_config(variant: str, patch_size: int, img_size: int = 224,
                          **kwargs: Any) -> MLPMixer:
    n_layers, d_model = MIXER_VARIANTS[variant]
    return MLPMixer(n_layers=n_layers, d_model=d_model, patch_size=patch_size,
                    img_size=img_size, **kwargs)


for _v, _p in (("S", 8), ("S", 16), ("S", 32), ("B", 16), ("B", 32), ("L", 16)):
    register_model(f"mixer_{_v.lower()}_{_p}")(
        lambda variant=_v, patch_size=_p, img_size=224, **kw: mlp_mixer_from_config(
            variant, patch_size, img_size, **kw))
