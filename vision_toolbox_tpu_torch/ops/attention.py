"""Attention core op — port of ``vision_toolbox_tpu/ops/attention.py``.

Layout (batch, seq, heads, head_dim), scale head_dim**-0.5, optional
additive bias broadcasting against (B, N, T, S).

The dispatch is the JAX package's, on every device. Without attention
dropout: short unbiased attention goes to the short-attention kernel (K2,
``ops/short_attention.py``; 2 ≤ T, S ≤ 512, heads ≤ 128, and ≥ 64
(batch·head) pairs, a test the op takes at run time); long 128-aligned
sequences to the flash kernel (K6, ``ops/flash_attention.py``); the rest to
``dense_attention``, ``jax.nn.dot_product_attention``'s rounding. The
kernels' ops run their hand-written CUDA kernels on CUDA tensors and their
plain versions on CPU tensors. With attention dropout, the JAX package's
manual path below.

The rules are decided on the unsharded attention, as JAX's GSPMD trace
sees it: inside a sharded step the pair test counts the global batch (q's
rows times the data axis's size, ``parallel/mesh.active_data_axis``), and
a token-sharded ViT passes its unsharded batch and length (``unsharded``),
so that n ranks run the kernels one process runs.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..nn.layers import dropout
from ..parallel.mesh import data_axis_size
from .flash_attention import flash_attention, use_flash_attention
from .short_attention import dense_attention, short_attention_packed, short_shape


def dot_product_attention(
    q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None = None, dropout_rate: float = 0.0,
    generator: torch.Generator | None = None, *, plain: bool = False,
    unsharded: tuple[int, int] | None = None,
) -> Tensor:
    """softmax(q·kᵀ/√d + bias)·v on (B, T, N, H) q and (B, S, N, H) k, v.
    Attention dropout draws its mask from ``generator``; ``plain`` runs the
    K2 and K6 kernels' plain versions on any device (for checking the
    kernels); ``unsharded`` is the (batch, query length) the kernels' rules
    are decided on (by default q's length and its rows times the data
    axis's size).

    Rounding points are the JAX package's: K2's (f32 p, ``short_attention``)
    and K6's where they run, ``dense_attention``'s elsewhere. With dropout,
    the JAX package's manual path: q·scale, the logits and the softmax in
    the input type."""
    B, T, N, H = q.shape
    rows, t = unsharded or (B * data_axis_size(), T)
    if dropout_rate == 0.0:
        if bias is None and short_shape(t, k.shape[1], H):
            pairs = None if (rows, t) == (B, T) else rows * N
            return short_attention_packed(q, k, v, plain=plain, pairs=pairs)
        if use_flash_attention(t):
            return flash_attention(q, k, v, bias, plain=plain)
        return dense_attention(q, k, v, bias)
    # manual path with attention dropout, in the input type (the scale too,
    # as JAX rounds a Python scalar to the array's type)
    scale = H**-0.5
    logits = torch.einsum("btnh,bsnh->bnts", q * torch.tensor(scale, dtype=q.dtype), k)
    if bias is not None:
        logits = logits + bias
    e = torch.exp(logits - logits.amax(-1, keepdim=True))  # jax.nn.softmax
    probs = dropout(e / e.sum(-1, keepdim=True), dropout_rate, generator)
    return torch.einsum("bnts,bsnh->btnh", probs, v.to(probs.dtype)).to(q.dtype)
