"""Transformer building blocks: MHA, MLP, ViTBlock, MHAPooling — port of
``vision_toolbox_tpu/nn/attention.py``.

Pre-LN blocks with separate q/k/v/out projections, exact-erf GELU on the
unfused path, optional LayerScale and StochasticDepth. ``ViTBlock`` sends
each half to its fused kernel (``ops/block_attention.py``,
``ops/block_mlp.py``) when the kernel's shape rule admits it, on every
device: on CPU tensors the fused ops run their plain versions, so a module
computes the same function wherever it runs. The fused ops are
differentiable: training runs their backward kernels. ``force_unfused``
keeps the block on the plain module chain, as a ViT with dropout does (the
fused kernels refuse it); there ``MHA``'s attention core
(``ops/attention.py``) runs the short-attention kernel K2 at vision shapes
(T, S ≤ 512, heads ≤ 128, ≥ 64 batch·head pairs: vit_b_16 from batch 6),
forward and backward, and the projections and the MLP stay ``torch.matmul``,
as the JAX package leaves them to XLA on that chain. Parameters are
float32; ``dtype`` is the compute type, to which they are rounded at use
where the JAX package promotes them (LayerNorms apply theirs in f32 on the
unfused path, as flax does). Dropout, attention dropout and stochastic depth draw from the
``generator`` threaded through ``forward``. A ``ViTBlock``'s forward runs inside a
``block`` span (``utils/tracing.py``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor, nn

from ..ops import block_attention, block_mlp
from ..ops.attention import dot_product_attention
from ..parallel.mesh import SeqShard, gather_tokens
from ..utils import tracing
from .layers import (
    LayerNorm, LayerScale, Linear, StochasticDepth, _gelu_exact, as_dtype, dropout,
)


class MHA(nn.Module):
    """Multi-head attention with separate q/k/v/out projections."""

    def __init__(self, d_model: int, n_heads: int, bias: bool = True, dropout: float = 0.0, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        self.d_model, self.n_heads, self.dropout = d_model, n_heads, dropout
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(d_model, d_model, bias, dtype=dtype, generator=generator))

    def _split(self, x: Tensor) -> Tensor:
        return x.reshape(*x.shape[:-1], self.n_heads, -1)

    def forward(self, q: Tensor, k: Tensor | None = None, v: Tensor | None = None, *,
                attn_bias: Tensor | None = None, train: bool = False, plain: bool = False,
                generator: torch.Generator | None = None, seq: SeqShard | None = None) -> Tensor:
        """``plain`` runs the attention kernels' plain PyTorch versions on any
        device (for checking the kernels). ``seq``: the tokens are this
        rank's slice of a token-sharded sequence; K and V are all-gathered
        over its axis (one collective), and the kernels are dispatched on
        its unsharded shape."""
        k = q if k is None else k
        v = k if v is None else v
        k, v = self._split(self.k_proj(k)), self._split(self.v_proj(v))
        unsharded = None
        if seq is not None:
            k, v = gather_tokens(torch.cat([k, v], -1), seq.axis, True, "kv").chunk(2, -1)
            unsharded = (seq.rows, seq.tokens)
        out = dot_product_attention(
            self._split(self.q_proj(q)), k, v, bias=attn_bias,
            dropout_rate=self.dropout if train else 0.0, generator=generator, plain=plain,
            unsharded=unsharded,
        )
        return self.out_proj(out.reshape(*out.shape[:-2], self.d_model))


class MLP(nn.Module):
    """linear1 → GELU → linear2 → dropout."""

    def __init__(self, in_dim: int, hidden_dim: int, dropout: float = 0.0, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        self.linear1 = Linear(in_dim, hidden_dim, dtype=dtype, generator=generator)
        self.linear2 = Linear(hidden_dim, in_dim, dtype=dtype, generator=generator)
        self.dropout = dropout

    def forward(self, x: Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> Tensor:
        x = self.linear2(_gelu_exact(self.linear1(x)))
        return dropout(x, self.dropout, generator) if train else x


def float_linears(*linears: nn.Module) -> bool:
    """Whether each of ``linears`` is a float ``Linear``, whose weight the
    fused half-block kernels read. A half-block whose projections were
    quantized (``utils/int8_serving.Int8Linear``) takes its module chain."""
    return all(isinstance(m, Linear) for m in linears)


def fused_mlp_halfblock(
    x: Tensor, norm: LayerNorm, linear1: Linear, linear2: Linear, scale: LayerScale | None,
    droppath: StochasticDepth | None, *, residual: Tensor | None = None, train: bool,
    plain: bool = False, generator: torch.Generator | None = None,
) -> Tensor:
    """LN → W1 → GELU → W2 → LayerScale → drop-path → residual through the
    fused MLP op (``ops/block_mlp.py``), reading the parameters of the same
    modules the unfused path uses (an ``MLP``'s two linears, or ConvNeXt's
    ``pwconv1``/``pwconv2``; the Mixer's channel mixing, which has no γ and
    no drop-path): LN parameters, biases and γ rounded to
    ``x.dtype`` as the JAX package promotes them, weights as they are (the op
    rounds them to bf16). The residual is ``x`` unless ``residual`` is given
    (ConvNeXt adds the block input to the MLP of its depthwise conv's
    output). ``plain`` runs the op's plain PyTorch versions on any device
    (for checking the kernels)."""
    dt = x.dtype
    return block_mlp.fused_mlp_block(
        x, norm.weight.to(dt), norm.bias.to(dt),
        linear1.weight, as_dtype(linear1.bias, dt), linear2.weight, as_dtype(linear2.bias, dt),
        None if scale is None else as_dtype(scale.gamma, dt),
        None if droppath is None else droppath.sample_scale(x.shape[0], train, generator,
                                                            device=x.device),
        residual=None if residual is None else as_dtype(residual, dt), eps=norm.eps,
        plain=plain,
    )


class ViTBlock(nn.Module):
    """Pre-LN transformer block with optional LayerScale + StochasticDepth
    and a pluggable attention module: ``attention(generator)`` builds it
    (CaiT's talking-head attention); such a block runs its attention half
    through the module chain, never the fused attention op, and keeps the
    fused MLP half."""

    def __init__(self, d_model: int, n_heads: int, bias: bool = True, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, layer_scale_init: float | None = None,
                 stochastic_depth: float = 0.0, norm_eps: float = 1e-6, *,
                 attention: Callable[[torch.Generator], nn.Module] | None = None,
                 dtype: torch.dtype | None = None, generator: torch.Generator):
        super().__init__()
        self.d_model, self.n_heads, self.bias, self.dropout = d_model, n_heads, bias, dropout
        self.hidden = int(d_model * mlp_ratio)
        ls = layer_scale_init
        self.mha_norm = LayerNorm(d_model, norm_eps)
        self.custom_attention = attention is not None
        self.mha = (attention(generator) if attention is not None
                    else MHA(d_model, n_heads, bias, dropout, dtype=dtype, generator=generator))
        self.mha_scale = LayerScale(d_model, ls) if ls is not None else None
        self.mha_droppath = StochasticDepth(stochastic_depth)
        self.mlp_norm = LayerNorm(d_model, norm_eps)
        self.mlp = MLP(d_model, self.hidden, dropout, dtype=dtype, generator=generator)
        self.mlp_scale = LayerScale(d_model, ls) if ls is not None else None
        self.mlp_droppath = StochasticDepth(stochastic_depth)

    def forward(self, x: Tensor, train: bool = False, *, force_unfused: bool = False,
                plain: bool = False, generator: torch.Generator | None = None,
                attn_bias: Tensor | None = None, seq: SeqShard | None = None) -> Tensor:
        """``plain`` routes the fused halves and the attention kernels
        through their plain PyTorch versions (forward and backward) instead of
        the kernels. ``attn_bias`` and ``seq`` (sequence parallelism:
        ``MHA``) reach the attention of the module chain; a block given
        ``seq`` takes that chain."""
        with tracing.span("block"):
            g = generator
            fused = x.ndim == 3 and not force_unfused and seq is None
            if self.custom_attention:
                y = self.mha(self.mha_norm(x), train=train, plain=plain, generator=g)
                if self.mha_scale is not None:
                    y = self.mha_scale(y)
                x = x + self.mha_droppath(y, train=train, generator=g)
            elif (fused and float_linears(self.mha.q_proj, self.mha.k_proj, self.mha.v_proj,
                                          self.mha.out_proj)
                  and block_attention.use_fused_attention(
                      self.d_model, self.n_heads, x.shape[1], self.dropout, self.bias)):
                a, dt = self.mha, x.dtype
                wb = [t for proj in (a.q_proj, a.k_proj, a.v_proj, a.out_proj)
                      for t in (proj.weight, as_dtype(proj.bias, dt))]
                x = block_attention.fused_attention_block(
                    x, self.mha_norm.weight.to(dt), self.mha_norm.bias.to(dt), *wb, self.n_heads,
                    None if self.mha_scale is None else as_dtype(self.mha_scale.gamma, dt),
                    self.mha_droppath.sample_scale(x.shape[0], train, g, device=x.device),
                    eps=self.mha_norm.eps, plain=plain,
                )
            else:
                y = self.mha(self.mha_norm(x), train=train, plain=plain, generator=g,
                             attn_bias=attn_bias, seq=seq)
                if self.mha_scale is not None:
                    y = self.mha_scale(y)
                x = x + self.mha_droppath(y, train=train, generator=g)

            if (fused and float_linears(self.mlp.linear1, self.mlp.linear2)
                    and block_mlp.use_fused_mlp(self.d_model, self.hidden, x.shape[1],
                                                self.dropout, has_ls=self.mlp_scale is not None)):
                return fused_mlp_halfblock(x, self.mlp_norm, self.mlp.linear1, self.mlp.linear2,
                                           self.mlp_scale, self.mlp_droppath, train=train,
                                           plain=plain, generator=g)
            y = self.mlp(self.mlp_norm(x), train=train, generator=g)
            if self.mlp_scale is not None:
                y = self.mlp_scale(y)
            return x + self.mlp_droppath(y, train=train, generator=g)


class MHAPooling(nn.Module):
    """SigLIP MAP head: a learned probe attends over the tokens."""

    def __init__(self, d_model: int, n_heads: int, bias: bool = True, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-6, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator):
        super().__init__()
        self.probe = nn.Parameter(torch.zeros(1, 1, d_model))
        self.mha = MHA(d_model, n_heads, bias, dtype=dtype, generator=generator)
        self.norm = LayerNorm(d_model, norm_eps)
        self.mlp = MLP(d_model, int(d_model * mlp_ratio), dtype=dtype, generator=generator)

    def forward(self, x: Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> Tensor:
        probe = self.probe.expand(x.shape[0], 1, -1).to(x.dtype)
        out = self.mha(probe, x, train=train, generator=generator)[:, 0]
        return out + self.mlp(self.norm(out), train=train, generator=generator)
