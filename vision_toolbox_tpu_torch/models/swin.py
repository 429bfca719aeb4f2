"""Swin Transformer and the AutoFormerV2-S3 variants — port of
``vision_toolbox_tpu/models/swin.py``.

NHWC throughout, as in the JAX package. A block is LayerNorm → window
attention → (LayerScale) → drop path, added to its input, then the MLP half.
Window attention (``WindowAttention``):

- the map is cut into w × w windows; on shifted blocks (odd blocks of a
  stage whose grid is larger than its window, shift w // 2) it is first
  rolled by (−s, −s) — both in one pass of the K8 kernel
  (``ops/swin_relayout.py``), unshifted blocks by reshape/permute;
- q, k and v are projected in the packed (B, nW, w², D) layout and attend
  within each window through the K7 kernels (``ops/swin_attention.py``),
  with the learnable relative-position bias gathered from its
  ((2w − 1)², heads) table and, on shifted blocks, the constant −100 shift
  mask, both in the projections' type and added separately in f32;
- with attention dropout in training it runs the JAX module's einsum path
  instead (the bias summed in the compute type, the softmax in it, dropout
  from the generator), as that module does;
- the output projection, then the inverse relayout (K8 again on shifted
  blocks).

The MLP half is the fused MLP half-block (``nn/attention.fused_mlp_halfblock``,
the K3 kernels on the card) wherever K3's shape rule admits the width (every
registered Swin), else the module chain. Between stages ``PatchMerging``
concatenates each 2×2 neighbourhood in the JAX order, normalises it and
projects 4C → 2C without a bias. Every block has the same stochastic-depth
rate. ``get_feature_maps`` returns the four stages' NHWC outputs and
``forward`` the mean over space of the normalised last one.

Parameters are drawn in float32 from an explicit ``torch.Generator`` (seed 0
when none is given) and moved to ``device``, the card unless the caller asks
for another; ``dtype`` is the compute type they are rounded to at use.
Module names follow the JAX tree (``patch_embed``, ``patch_norm``,
``downsample_<i>`` with ``norm`` and ``reduction``, ``mha`` with ``q_proj``,
``k_proj``, ``v_proj``, ``out_proj`` and ``relative_pe_table``, ``norm``); its
``stage_<i>_block_<j>`` are ``stages.<i>.<j>`` here.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch
from torch import Tensor, nn

from ..nn.attention import MLP, fused_mlp_halfblock
from ..nn.initializers import trunc_normal
from ..nn.layers import Conv2d, LayerNorm, LayerScale, Linear, StochasticDepth, dropout
from ..ops import block_mlp
from ..ops.swin_attention import swin_window_attention
from ..ops.swin_relayout import (
    shifted_window_partition, shifted_window_unpartition, use_swin_relayout, window_partition,
    window_unpartition,
)
from .base import Backbone, register_model, to_device
from .vit import _resize_weights


def _relative_pe_index(window_size: int) -> np.ndarray:
    """(w², w²) gather index into the (2w − 1)² relative-PE table."""
    w = window_size
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"), -1).reshape(-1, 2)
    diff = coords[:, None, :] - coords[None, :, :]
    return (diff[..., 0] + w - 1) * (2 * w - 1) + diff[..., 1] + w - 1


def _shift_attn_mask(input_size: int, window_size: int, shift: int) -> np.ndarray:
    """(nW, w², w²) additive mask: −100 between tokens from different image
    regions after the cyclic shift."""
    s = input_size
    img_mask = np.zeros((s, s), np.float32)
    slices = (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    nh = s // window_size
    windows = (
        img_mask.reshape(nh, window_size, nh, window_size)
        .transpose(0, 2, 1, 3)
        .reshape(nh * nh, window_size * window_size)
    )
    diff = windows[:, None, :] - windows[:, :, None]
    return (diff != 0).astype(np.float32) * -100.0


class WindowAttention(nn.Module):
    """Windowed multi-head attention with a relative-position bias and an
    optional cyclic shift."""

    def __init__(self, input_size: int, d_model: int, n_heads: int, window_size: int = 7,
                 shift: bool = False, bias: bool = True, dropout: float = 0.0, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        w = window_size
        self.d_model, self.n_heads, self.window_size, self.dropout = d_model, n_heads, w, dropout
        self.shift = w // 2 if shift else 0
        self.relative_pe_table = nn.Parameter(trunc_normal(0.02)((1, n_heads, (2 * w - 1) ** 2),
                                                                 generator))
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(d_model, d_model, bias, dtype=dtype, generator=generator))
        self.register_buffer("pe_index", torch.from_numpy(_relative_pe_index(w)).long(),
                             persistent=False)
        mask = _shift_attn_mask(input_size, w, self.shift) if self.shift else None
        self.register_buffer("shift_mask", None if mask is None else torch.from_numpy(mask),
                             persistent=False)

    def forward(self, x: Tensor, train: bool = False, *, plain: bool = False,
                generator: torch.Generator | None = None) -> Tensor:
        """``plain`` runs the K7 and K8 kernels' plain versions on any device."""
        B, H, W, C = x.shape
        w, s, N = self.window_size, self.shift, self.n_heads
        if use_swin_relayout(s):
            windows = shifted_window_partition(x, w, s, plain=plain)
        else:
            windows = window_partition(x, w)
        qp, kp, vp = self.q_proj(windows), self.k_proj(windows), self.v_proj(windows)
        table = self.relative_pe_table[:, :, self.pe_index]  # (1, N, w², w²)
        if self.dropout > 0 and train:
            out = self._einsum_attention(qp, kp, vp, table.to(x.dtype), generator)
        else:
            mask = None if self.shift_mask is None else self.shift_mask.to(qp.dtype)
            out = swin_window_attention(qp, kp, vp, table.to(qp.dtype), mask, N, plain=plain)
        out = self.out_proj(out)
        if use_swin_relayout(s):
            return shifted_window_unpartition(out, w, s, H, W, plain=plain)
        return window_unpartition(out, w, H // w, W // w)

    def _einsum_attention(self, qp: Tensor, kp: Tensor, vp: Tensor, pe: Tensor,
                          generator: torch.Generator | None) -> Tensor:
        """The JAX module's einsum path, at its rounding points: the bias
        (pe plus the shift mask) summed in the compute type, q·scale, the
        logits, the softmax and the dropout in the input type."""
        B, nW, T, D = qp.shape
        N = self.n_heads
        heads = lambda t: t.reshape(B, nW, T, N, D // N)
        bias = pe[:, None]  # (1, 1, N, T, T)
        if self.shift_mask is not None:
            bias = bias + self.shift_mask.to(pe.dtype)[None, :, None]
        q, k, v = heads(qp), heads(kp), heads(vp)
        scale = torch.tensor((D // N) ** -0.5, dtype=q.dtype)  # JAX rounds it to q's type
        logits = torch.einsum("bnqhd,bnkhd->bnhqk", q * scale, k) + bias
        e = torch.exp(logits - logits.amax(-1, keepdim=True))  # jax.nn.softmax
        probs = dropout(e / e.sum(-1, keepdim=True), self.dropout, generator)
        return torch.einsum("bnhqk,bnkhd->bnqhd", probs, v).reshape(B, nW, T, D)


class SwinBlock(nn.Module):
    """Pre-LN block on (B, H, W, C) with window attention."""

    def __init__(self, input_size: int, d_model: int, n_heads: int, window_size: int = 7,
                 shift: bool = False, mlp_ratio: float = 4.0, bias: bool = True,
                 dropout: float = 0.0, layer_scale_init: float | None = None,
                 stochastic_depth: float = 0.0, norm_eps: float = 1e-5, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        hidden = int(d_model * mlp_ratio)
        ls = layer_scale_init
        self.mha_norm = LayerNorm(d_model, norm_eps)
        self.mha = WindowAttention(input_size, d_model, n_heads, window_size, shift, bias,
                                   dropout, dtype=dtype, generator=generator)
        self.mha_scale = LayerScale(d_model, ls) if ls is not None else None
        self.mha_droppath = StochasticDepth(stochastic_depth)
        self.mlp_norm = LayerNorm(d_model, norm_eps)
        self.mlp = MLP(d_model, hidden, dropout, dtype=dtype, generator=generator)
        self.mlp_scale = LayerScale(d_model, ls) if ls is not None else None
        self.mlp_droppath = StochasticDepth(stochastic_depth)

    def fused_at(self, t: int) -> bool:
        """Whether the MLP half runs the fused kernel on maps of ``t`` tokens."""
        hidden, d_model = self.mlp.linear1.weight.shape
        return block_mlp.use_fused_mlp(d_model, hidden, t, self.mlp.dropout,
                                       has_ls=self.mlp_scale is not None)

    def forward(self, x: Tensor, train: bool = False, *, force_unfused: bool = False,
                plain: bool = False, generator: torch.Generator | None = None) -> Tensor:
        """``force_unfused`` keeps the MLP half on the module chain; ``plain``
        runs the kernels' plain versions on any device."""
        g = generator
        y = self.mha(self.mha_norm(x), train, plain=plain, generator=g)
        if self.mha_scale is not None:
            y = self.mha_scale(y)
        x = x + self.mha_droppath(y, train=train, generator=g)
        B, H, W, C = x.shape
        if not force_unfused and self.fused_at(H * W):
            out = fused_mlp_halfblock(x.reshape(B, H * W, C), self.mlp_norm, self.mlp.linear1,
                                      self.mlp.linear2, self.mlp_scale, self.mlp_droppath,
                                      train=train, plain=plain, generator=g)
            return out.reshape(B, H, W, C)
        y = self.mlp(self.mlp_norm(x), train=train, generator=g)
        if self.mlp_scale is not None:
            y = self.mlp_scale(y)
        return x + self.mlp_droppath(y, train=train, generator=g)


class PatchMerging(nn.Module):
    """2×2 neighbourhood concatenation → LayerNorm → linear 4C → 2C, no bias."""

    def __init__(self, d_model: int, norm_eps: float = 1e-5, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        self.norm = LayerNorm(4 * d_model, norm_eps)
        self.reduction = Linear(4 * d_model, 2 * d_model, False, dtype=dtype, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))


class SwinTransformer(Backbone):
    def __init__(
        self, img_size: int, d_model: int, n_heads: int, depths: tuple[int, ...],
        window_sizes: tuple[int, ...], patch_size: int = 4, mlp_ratio: float = 4.0,
        bias: bool = True, dropout: float = 0.0, layer_scale_init: float | None = None,
        stochastic_depth: float = 0.0, norm_eps: float = 1e-5, *,
        dtype: torch.dtype | None = None, device: torch.device | str = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.d_model, self.depths, self.window_sizes = d_model, tuple(depths), tuple(window_sizes)
        self.patch_size, self.dropout = patch_size, dropout
        self.compute_dtype = torch.float32 if dtype is None else dtype
        self.patch_embed = Conv2d(3, d_model, patch_size, patch_size, dtype=dtype, generator=gen)
        self.patch_norm = LayerNorm(d_model, norm_eps)
        size, d, heads = img_size // patch_size, d_model, n_heads
        self.stages = nn.ModuleList()
        for i, (depth, w) in enumerate(zip(self.depths, self.window_sizes)):
            if i > 0:
                setattr(self, f"downsample_{i}", PatchMerging(d, norm_eps, dtype=dtype,
                                                              generator=gen))
                size, d, heads = size // 2, 2 * d, 2 * heads
            self.stages.append(nn.ModuleList(
                SwinBlock(size, d, heads, w, bool(j % 2) and size > w, mlp_ratio, bias, dropout,
                          layer_scale_init, stochastic_depth, norm_eps, dtype=dtype,
                          generator=gen)
                for j in range(depth)))
        self.norm = LayerNorm(d, norm_eps)
        to_device(self, device)

    def get_feature_maps(self, x: Tensor, train: bool = False, *, force_unfused: bool = False,
                         plain: bool = False,
                         generator: torch.Generator | None = None) -> list[Tensor]:
        """x: (B, H, W, 3) NHWC → the four stages' NHWC outputs."""
        x = self.patch_norm(self.patch_embed(x))
        if train:
            x = dropout(x, self.dropout, generator)
        outputs = []
        for i, blocks in enumerate(self.stages):
            if i > 0:
                x = getattr(self, f"downsample_{i}")(x)
            for block in blocks:
                x = block(x, train, force_unfused=force_unfused, plain=plain, generator=generator)
            outputs.append(x)
        return outputs

    def forward(self, x: Tensor, train: bool = False, generator: torch.Generator | None = None, *,
                force_unfused: bool = False, plain: bool = False) -> Tensor:
        """(B, C) features: the mean over space of the normalised last stage.
        ``force_unfused`` keeps the MLP halves on the module chain; ``plain``
        runs the kernels' plain versions (for checking them on the card)."""
        out = self.get_feature_maps(x, train, force_unfused=force_unfused, plain=plain,
                                    generator=generator)[-1]
        return self.norm(out).mean((1, 2))

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        return tuple(self.d_model * 2**i for i in range(len(self.depths)))

    @property
    def stride(self) -> int:
        return self.patch_size * 2 ** (len(self.depths) - 1)


_TABLE = re.compile(r"(?:^|\.)stages\.(\d+)\.(\d+)\.mha\.relative_pe_table$")


def resize_window_tables(state_dict: dict[str, Tensor], old_windows: tuple[int, ...],
                         new_windows: tuple[int, ...]) -> dict[str, Tensor]:
    """Carry a Swin state dict to other window sizes: each block's
    relative-PE table (1, heads, (2w − 1)²) is resized over its
    (2w − 1) × (2w − 1) offset grid as the JAX package's
    ``resize_window_tables`` does with ``jax.image.resize`` (bicubic, Keys
    a = −0.5, half-pixel centres, antialiased when shrinking; the weights of
    ``models/vit._resize_weights``), in f32. Returns a new dict; the other
    entries are the same tensors."""
    out = dict(state_dict)
    for name, table in state_dict.items():
        m = _TABLE.search(name)
        if m is None:
            continue
        ow, nw = old_windows[int(m.group(1))], new_windows[int(m.group(1))]
        if ow == nw:
            continue
        heads, n_in, n_out = table.shape[1], 2 * ow - 1, 2 * nw - 1
        wts = _resize_weights(n_in, n_out).to(table.device)
        grid = torch.einsum("ia,jb,hij->hab", wts, wts, table.float().reshape(heads, n_in, n_in))
        out[name] = grid.reshape(1, heads, n_out * n_out).to(table.dtype)
    return out


SWIN_VARIANTS = {  # d_model, heads, depths, windows (vision_toolbox_tpu/models/swin.py)
    "T": (96, 3, (2, 2, 6, 2), (7, 7, 7, 7)),
    "S": (96, 3, (2, 2, 18, 2), (7, 7, 7, 7)),
    "B": (128, 4, (2, 2, 18, 2), (7, 7, 7, 7)),
    "L": (192, 6, (2, 2, 18, 2), (7, 7, 7, 7)),
    "S3-T": (96, 3, (2, 2, 6, 2), (7, 7, 14, 7)),
    "S3-S": (96, 3, (2, 2, 18, 2), (14, 14, 14, 14)),
    "S3-B": (96, 3, (2, 2, 30, 2), (7, 7, 14, 7)),
}


def swin_from_config(variant: str, img_size: int = 224, **kwargs: Any) -> SwinTransformer:
    d_model, n_heads, depths, window_sizes = SWIN_VARIANTS[variant]
    kwargs.setdefault("d_model", d_model)
    kwargs.setdefault("n_heads", n_heads)
    kwargs.setdefault("depths", depths)
    kwargs.setdefault("window_sizes", window_sizes)
    return SwinTransformer(img_size=img_size, **kwargs)


for _v in SWIN_VARIANTS:
    register_model(f"swin_{_v.lower()}")(
        lambda variant=_v, img_size=224, **kw: swin_from_config(variant, img_size, **kw))
