"""Fused transformer self-attention half-block (K4 forward) — port of
``vision_toolbox_tpu/ops/block_attention.py``.

``out = x + dp·γ_ls·(MHA(LN(x))·Woᵀ + bo)``, unbiased multi-head
self-attention per image with q/k/v projected from the LayerNorm output.

``fused_attention_block`` is the custom op ``vtt::fused_attention_block``: on
CPU tensors it runs ``fused_attention_block_plain``, on CUDA tensors the
hand-written kernels in ``csrc/block_attention.cu`` (LN+q/k/v projection,
attention, out-projection+epilogue; see the note there). A CUDA tensor
launches the kernels or raises.

Rounding points are the TPU kernel's: fast-variance LayerNorm in f32, ``y``
rounded to bf16, q/k/v = bf16(y·Wᵀ + b) with f32 accumulation and f32 bias,
logits and softmax in f32 (max subtracted), ``p`` rounded to bf16,
``o = p·v`` accumulated in f32 and rounded to bf16, the out-projection
accumulated in f32, and the residual epilogue in f32 cast once to
``x.dtype``. Weights are in the ``nn.Linear`` layout (D_out, D_in).
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import _cuda
from .block_mlp import bf16_linear, ln_f32, residual_epilogue

MAX_SEQ = 512  # whole key rows of one image sit in one block's shared memory
SMEM_LIMIT = 227 * 1024  # H100 shared memory a block can use
_QUERY_TILE = 32  # csrc/block_attention.cu BQ


def _attn_smem_bytes(t: int, head_dim: int) -> int:
    """Shared memory of one attention block (csrc/block_attention.cu
    ``attn_smem_bytes``): K then V, the query tile, f32 logits, bf16 probs."""
    sp = -(-t // 16) * 16
    return (
        sp * (head_dim + 8) * 2
        + _QUERY_TILE * (head_dim + 8) * 2
        + _QUERY_TILE * (max(sp, head_dim) + 4) * 4
        + _QUERY_TILE * (sp + 8) * 2
    )


def use_fused_attention(d_model: int, n_heads: int, t: int, dropout: float, bias: bool) -> bool:
    """Shape rule of the CUDA kernels: the projections fill whole 64-column
    tiles, a head is a whole number of 16-wide tensor-core steps (≤ 128),
    and all T keys of an image fit one block's shared memory (T ≤ 512).
    vit_b_16 at 224 px (T=197, head_dim 64) takes 75.5 KB."""
    if dropout != 0.0 or not bias or n_heads <= 0 or d_model % n_heads:
        return False
    hd = d_model // n_heads
    return (
        d_model % 64 == 0
        and hd % 16 == 0
        and hd <= 128
        and 1 <= t <= MAX_SEQ
        and _attn_smem_bytes(t, hd) <= SMEM_LIMIT
    )


def fused_attention_block_plain(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, wq: Tensor, bq: Tensor, wk: Tensor,
    bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, n_heads: int,
    ls_gamma: Tensor | None = None, dp_scale: Tensor | None = None, eps: float = 1e-6,
) -> Tensor:
    """Plain PyTorch version of the kernels, same rounding points."""
    B, T, D = x.shape
    hd = D // n_heads
    y = (ln_f32(x.float(), eps) * ln_scale.float() + ln_bias.float()).to(torch.bfloat16)

    def heads(w, b):  # (B, H, T, hd) f32 of bf16-rounded values
        p = bf16_linear(y, w, b).to(torch.bfloat16).float()
        return p.reshape(B, T, n_heads, hd).transpose(1, 2)

    q, k, v = heads(wq, bq), heads(wk, bk), heads(wv, bv)
    logits = (q * hd**-0.5) @ k.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16).float()
    o = (p @ v).transpose(1, 2).reshape(B, T, D).to(torch.bfloat16)
    return residual_epilogue(x, None, bf16_linear(o, wo, bo), ls_gamma, dp_scale)


def fused_attention_block_cuda(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, wq: Tensor, bq: Tensor, wk: Tensor,
    bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, n_heads: int,
    ls_gamma: Tensor | None, dp_scale: Tensor | None, eps: float,
) -> Tensor:
    """Launch ``csrc/block_attention.cu`` on the current stream."""
    B, T, D = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention_block: x must be float32 or bfloat16, got {x.dtype}")
    if any(w.shape != (D, D) for w in (wq, wk, wv, wo)):
        raise ValueError(f"fused_attention_block: weights must be ({D}, {D})")
    if not use_fused_attention(D, n_heads, T, 0.0, True):
        raise ValueError(f"fused_attention_block: no CUDA kernel for d_model={D}, "
                         f"n_heads={n_heads}, t={T}; gate calls with use_fused_attention()")
    x = x.contiguous()
    ws = [w.to(torch.bfloat16).contiguous() for w in (wq, wk, wv, wo)]
    dp = None if dp_scale is None else dp_scale.float().contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # q, k, v, o: the intermediates that go through device memory
    qkvo = torch.empty(4, B * T, D, dtype=torch.bfloat16, device=x.device)
    vec = lambda t: _cuda.vec(None if t is None else t.contiguous())
    with torch.cuda.device(x.device):
        lib = _cuda.lib()
        err = lib.vtt_block_attention_fwd(
            _cuda.ptr(x), _cuda.ptr(out), *(_cuda.ptr(t) for t in qkvo),
            int(x.dtype == torch.bfloat16), *vec(ln_scale), *vec(ln_bias),
            _cuda.ptr(ws[0]), *vec(bq), _cuda.ptr(ws[1]), *vec(bk),
            _cuda.ptr(ws[2]), *vec(bv), _cuda.ptr(ws[3]), *vec(bo),
            *vec(ls_gamma), _cuda.ptr(dp),
            B, T, D, n_heads, float((D // n_heads) ** -0.5), float(eps), _cuda.stream(),
        )
        _cuda.check(err, "fused_attention_block")
    _cuda.LAUNCHES["block_attention"] += 1
    return out


@torch.library.custom_op("vtt::fused_attention_block", mutates_args=(), device_types="cpu")
def _fused_attn_op(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, wq: Tensor, bq: Tensor, wk: Tensor,
    bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, n_heads: int,
    ls_gamma: Tensor | None, dp_scale: Tensor | None, eps: float,
) -> Tensor:
    return fused_attention_block_plain(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                                       n_heads, ls_gamma, dp_scale, eps)


_fused_attn_op.register_kernel("cuda")(fused_attention_block_cuda)


@_fused_attn_op.register_fake
def _(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, n_heads, ls_gamma, dp_scale, eps):
    return torch.empty_like(x)


def fused_attention_block(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, wq: Tensor, bq: Tensor, wk: Tensor,
    bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, n_heads: int,
    ls_gamma: Tensor | None = None, dp_scale: Tensor | None = None, *, eps: float = 1e-6,
) -> Tensor:
    """``x + dp·γ_ls·(MHA(LN(x))·Woᵀ + bo)``; x: (B, T, D), all w (D, D) in
    the (out, in) layout, dp_scale: (B, 1) per-sample drop-path scale or None."""
    return _fused_attn_op(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, int(n_heads),
                          ls_gamma, dp_scale, float(eps))
