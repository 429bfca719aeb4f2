"""Attention core op — port of ``vision_toolbox_tpu/ops/attention.py``.

Layout (batch, seq, heads, head_dim), scale head_dim**-0.5, optional
additive bias broadcasting against (B, N, T, S).

Like the JAX package, long 128-aligned sequences go to the flash kernel
(K6, ``ops/flash_attention.py``) on every device: its hand-written CUDA
kernels on CUDA tensors (heads zero-padded to a multiple of 16; heads
wider than 256 raise), its plain versions on CPU tensors. The JAX package
sends short unbiased attention to its short-attention kernel (K2,
``ops/short_attention.py``), which is not ported yet, so on a CUDA tensor
those shapes raise ``NotImplementedError`` instead of running the plain math
in its place; every other shape, and every CPU tensor, runs the plain math
below.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..nn.layers import dropout
from .flash_attention import flash_attention, use_flash_attention

MAX_SHORT_SEQ = 512  # ops/short_attention.py use_short


def _unported_kernel(t: int, s: int, h: int, n_pairs: int, has_bias: bool) -> str | None:
    """Name of the unported TPU kernel the JAX package would dispatch this
    shape to, else None."""
    if not has_bias and 2 <= t <= MAX_SHORT_SEQ and 2 <= s <= MAX_SHORT_SEQ and h <= 128 \
            and n_pairs >= 64:
        return "K2 (short attention, vision_toolbox_tpu/ops/short_attention.py)"
    return None


def dot_product_attention(
    q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None = None, dropout_rate: float = 0.0,
    generator: torch.Generator | None = None, *, plain: bool = False,
) -> Tensor:
    """softmax(q·kᵀ/√d + bias)·v on (B, T, N, H) operands. Attention
    dropout draws its mask from ``generator``; ``plain`` runs the flash
    kernel's plain versions on any device (for checking the kernels).

    Rounding points are the JAX package's. Without dropout,
    ``jax.nn.dot_product_attention`` (jax 0.9.0
    ``_dot_product_attention_core``): the logits from the input-type
    operands accumulated in f32, scaled and biased in f32, the softmax in
    f32, then p rounded to v's type before p·v (accumulated in f32, rounded
    once to q's type). With dropout, the JAX package's manual path: q·scale,
    the logits and the softmax in the input type."""
    B, T, N, H = q.shape
    scale = H**-0.5
    if dropout_rate == 0.0:
        if use_flash_attention(T):
            return flash_attention(q, k, v, bias, plain=plain)
        if q.is_cuda:
            kernel = _unported_kernel(T, k.shape[1], H, B * N, bias is not None)
            if kernel is not None:
                raise NotImplementedError(
                    f"attention at T={T}, S={k.shape[1]}, head_dim={H} runs kernel {kernel} "
                    "in the JAX package; that kernel has no CUDA port yet"
                )
        logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
        if bias is not None:
            logits = logits + bias.float()
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bnts,bsnh->btnh", probs.float(), v.float()).to(q.dtype)
    # manual path with attention dropout, in the input type (the scale too,
    # as JAX rounds a Python scalar to the array's type)
    logits = torch.einsum("btnh,bsnh->bnts", q * torch.tensor(scale, dtype=q.dtype), k)
    if bias is not None:
        logits = logits + bias
    e = torch.exp(logits - logits.amax(-1, keepdim=True))  # jax.nn.softmax
    probs = dropout(e / e.sum(-1, keepdim=True), dropout_rate, generator)
    return torch.einsum("bnts,bsnh->btnh", probs, v.to(probs.dtype)).to(q.dtype)
