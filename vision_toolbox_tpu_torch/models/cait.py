"""CaiT, the class-attention image transformer — port of
``vision_toolbox_tpu/models/cait.py``.

- ``TalkingHeadAttention``: learnable (H, H) head mixes before and after the
  softmax; it runs ``ops/cait_attention.py`` (the K5 kernels on the card,
  their plain versions on CPU tensors) wherever its shape rule
  ``use_talking_head_kernel`` admits the shape: where the JAX module runs K5
  on a TPU, at any head width, and where only the CUDA kernels admit it
  (cait_m_* at 224 px: 16 heads at T = 196 exceed the TPU's VMEM budget).
  Everywhere else it runs the JAX module's XLA branch, as that module does
  (T > 512, e.g. cait_s_24 at 384 px; cait_m_* at 288 px; dropout in
  training). The mix parameters keep flax's names (``proj_l_kernel``,
  ``proj_l_bias``, ``proj_w_kernel``, ``proj_w_bias``) as direct float32
  parameters of the module: unsplit,
  ``proj_l_bias`` falls in the weight-decay group 'other', as in the JAX
  package, and the kernels read them in f32, so serving keeps them f32.
- ``ClassAttention``: the cls token is the only query; plain f32 attention
  math (``ops/attention.py``).
- The body: ``sa_depth`` ``ViTBlock``s with talking-head attention over the
  patch tokens (their MLP halves run the fused MLP op), then ``ca_depth``
  class-attention blocks that update only the cls token, whose MLP runs on
  the cls token alone as plain modules.

Parameters are drawn in float32 from an explicit ``torch.Generator`` (seed
0 when none is given) and moved to ``device``, the card unless the caller
asks for another; ``dtype`` is the compute type they are rounded to at use.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor, nn

from ..nn.attention import MLP, ViTBlock
from ..nn.initializers import normal, torch_default_bias, torch_default_kernel
from ..nn.layers import LayerNorm, LayerScale, Linear, StochasticDepth, as_dtype, dropout
from ..ops.attention import dot_product_attention
from ..ops.cait_attention import talking_head_attention, use_talking_head_kernel
from .base import Backbone, register_model, to_device
from .vit import PatchEmbed

MIX_PARAMS = ("proj_l_kernel", "proj_l_bias", "proj_w_kernel", "proj_w_bias")


class TalkingHeadAttention(nn.Module):
    """Self-attention with pre- and post-softmax (H, H) head mixes."""

    keeps_f32_params = True  # the mixes: Backbone.cast_for_serving leaves them f32

    def __init__(self, d_model: int, n_heads: int, bias: bool = True, dropout: float = 0.0, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        self.d_model, self.n_heads, self.dropout = d_model, n_heads, dropout
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(d_model, d_model, bias, dtype=dtype, generator=generator))
        H = n_heads
        self.proj_l_kernel = nn.Parameter(torch_default_kernel((H, H), generator))
        self.proj_l_bias = nn.Parameter(torch_default_bias(H)((H,), generator))
        self.proj_w_kernel = nn.Parameter(torch_default_kernel((H, H), generator))
        self.proj_w_bias = nn.Parameter(torch_default_bias(H)((H,), generator))

    def forward(self, x: Tensor, train: bool = False, *, plain: bool = False,
                generator: torch.Generator | None = None) -> Tensor:
        """The talking-head op where the JAX module's K5 rule or the CUDA
        kernels' rule admits the shape and no attention dropout is drawn (on
        a CUDA tensor it launches its kernels); otherwise the JAX package's
        XLA branch (``_xla_attention``). ``plain`` runs the op's
        plain versions on any device."""
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        mixes = [as_dtype(getattr(self, n), torch.float32) for n in MIX_PARAMS]
        T, H = x.shape[-2], self.n_heads
        if (self.dropout > 0 and train) or not use_talking_head_kernel(T, T, H, self.d_model // H):
            out = self._xla_attention(q, k, v, *mixes, train=train, generator=generator)
        else:
            out = talking_head_attention(q, k, v, *mixes, plain=plain)
        return self.out_proj(out)

    def _xla_attention(self, q: Tensor, k: Tensor, v: Tensor, ml: Tensor, mlb: Tensor,
                       mw: Tensor, mwb: Tensor, *, train: bool,
                       generator: torch.Generator | None) -> Tensor:
        """The JAX module's XLA branch at its rounding points: the logits
        ``q·(k·scale)`` in the input type, lifted to f32 by the f32
        pre-softmax mix, then the softmax, the post-softmax mix and the
        attention dropout in f32, and ·v (the output projection rounds it)."""
        B, T, _ = q.shape
        heads = lambda t: t.reshape(B, T, self.n_heads, -1)
        q, k, v = heads(q), heads(k), heads(v)
        scale = torch.tensor(q.shape[-1] ** -0.5, dtype=k.dtype)  # JAX rounds it to k's type
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k * scale)
        logits = torch.einsum("bhqk,gh->bgqk", logits.float(), ml) + mlb[:, None, None]
        probs = torch.softmax(logits, dim=-1)
        probs = torch.einsum("bhqk,gh->bgqk", probs, mw) + mwb[:, None, None]
        if train:
            probs = dropout(probs, self.dropout, generator)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).reshape(B, T, self.d_model)


class ClassAttention(nn.Module):
    """Attention pooling: the query is the cls token (the first token)."""

    def __init__(self, d_model: int, n_heads: int, bias: bool = True, dropout: float = 0.0, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(d_model, d_model, bias, dtype=dtype, generator=generator))

    def forward(self, x: Tensor) -> Tensor:
        B, H = x.shape[0], self.n_heads
        q = self.q_proj(x[:, :1]).reshape(B, 1, H, -1)
        k = self.k_proj(x).reshape(B, -1, H, self.d_model // H)
        v = self.v_proj(x).reshape(B, -1, H, self.d_model // H)
        return self.out_proj(dot_product_attention(q, k, v).reshape(B, 1, self.d_model))


class CaiTCABlock(nn.Module):
    """Class-attention block: attention over cat(cls, patches) updates the
    cls token only; the MLP runs on the cls token only."""

    def __init__(self, d_model: int, n_heads: int, bias: bool = True, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, layer_scale_init: float | None = 1e-6,
                 stochastic_depth: float = 0.0, norm_eps: float = 1e-6, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        ls = layer_scale_init
        self.mha_norm = LayerNorm(d_model, norm_eps)
        self.mha = ClassAttention(d_model, n_heads, bias, dropout, dtype=dtype, generator=generator)
        self.mha_scale = LayerScale(d_model, ls) if ls is not None else None
        self.mha_droppath = StochasticDepth(stochastic_depth)
        self.mlp_norm = LayerNorm(d_model, norm_eps)
        self.mlp = MLP(d_model, int(d_model * mlp_ratio), dropout, dtype=dtype, generator=generator)
        self.mlp_scale = LayerScale(d_model, ls) if ls is not None else None
        self.mlp_droppath = StochasticDepth(stochastic_depth)

    def forward(self, patches: Tensor, cls: Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> Tensor:
        y = self.mha(self.mha_norm(torch.cat([cls, patches], dim=1)))
        if self.mha_scale is not None:
            y = self.mha_scale(y)
        cls = cls + self.mha_droppath(y, train=train, generator=generator)
        y = self.mlp(self.mlp_norm(cls), train=train, generator=generator)
        if self.mlp_scale is not None:
            y = self.mlp_scale(y)
        return cls + self.mlp_droppath(y, train=train, generator=generator)


class CaiT(Backbone):
    def __init__(
        self, d_model: int, sa_depth: int, ca_depth: int, n_heads: int, patch_size: int,
        img_size: int, bias: bool = True, mlp_ratio: float = 4.0, dropout: float = 0.0,
        layer_scale_init: float | None = 1e-6, stochastic_depth: float = 0.0,
        norm_eps: float = 1e-6, *, dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda", generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.d_model, self.patch_size, self.img_size = d_model, patch_size, img_size
        self.compute_dtype = torch.float32 if dtype is None else dtype
        common = dict(bias=bias, mlp_ratio=mlp_ratio, dropout=dropout,
                      layer_scale_init=layer_scale_init, stochastic_depth=stochastic_depth,
                      norm_eps=norm_eps, dtype=dtype, generator=gen)

        def attention(g: torch.Generator) -> TalkingHeadAttention:
            return TalkingHeadAttention(d_model, n_heads, bias, dropout, dtype=dtype, generator=g)

        self.patch_embed = PatchEmbed(d_model, patch_size, generator=gen)
        self.pe = nn.Parameter(normal(0.02)((1, (img_size // patch_size) ** 2, d_model), gen))
        self.sa_blocks = nn.ModuleList(ViTBlock(d_model, n_heads, attention=attention, **common)
                                       for _ in range(sa_depth))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model))
        self.ca_blocks = nn.ModuleList(CaiTCABlock(d_model, n_heads, **common)
                                       for _ in range(ca_depth))
        self.norm = LayerNorm(d_model, norm_eps)
        to_device(self, device)

    def forward(self, x: Tensor, train: bool = False, *, force_unfused: bool = False,
                plain: bool = False, generator: torch.Generator | None = None) -> Tensor:
        """x: (B, H, W, 3) NHWC → (B, D), the normalised cls token.
        ``force_unfused`` keeps the MLP halves on the module chain;
        ``plain`` runs the kernels' plain versions instead of the kernels
        (for checking them on the card)."""
        patches = self._tokens(x)
        for block in self.sa_blocks:
            patches = block(patches, train, force_unfused=force_unfused, plain=plain,
                            generator=generator)
        return self._pool(patches, train, generator)

    def _tokens(self, x: Tensor) -> Tensor:
        """NHWC image → (B, H·W, D) patch tokens + PE, in the compute type."""
        dt = self.compute_dtype
        return self.patch_embed(as_dtype(x, dt)) + as_dtype(self.pe, dt)

    def _pool(self, patches: Tensor, train: bool = False,
              generator: torch.Generator | None = None) -> Tensor:
        """The class-attention stage over the patches, then the norm."""
        cls = as_dtype(self.cls_token, patches.dtype).expand(patches.shape[0], -1, -1)
        for block in self.ca_blocks:
            cls = block(patches, cls, train=train, generator=generator)
        return self.norm(cls[:, 0])

    @property
    def last_out_channels(self) -> int:
        return self.d_model


CAIT_DMODEL = {"xxs": 192, "xs": 288, "s": 384, "m": 768}


def cait_from_config(variant: str, img_size: int = 224, **kwargs: Any) -> CaiT:
    """``variant`` like "s_24": width and self-attention depth; two
    class-attention blocks, heads of width 48, patch 16."""
    name, sa_depth = variant.split("_")
    d_model = CAIT_DMODEL[name]
    return CaiT(d_model=d_model, sa_depth=int(sa_depth), ca_depth=2, n_heads=d_model // 48,
                patch_size=16, img_size=img_size, **kwargs)


for _v in ("xxs_24", "xxs_36", "xs_24", "s_24", "s_36", "m_36", "m_48"):
    register_model(f"cait_{_v}")(
        lambda variant=_v, img_size=224, **kw: cait_from_config(variant, img_size, **kw)
    )
