"""Fused transformer MLP half-block (K3 forward) — port of
``vision_toolbox_tpu/ops/block_mlp.py``.

``out = r + dp·γ_ls·(gelu(LN(x)·W1ᵀ + b1)·W2ᵀ + b2)`` with ``r`` the
separate ``residual`` if given, else ``x``.

``fused_mlp_block`` is the custom op ``vtt::fused_mlp_block``: on CPU tensors
it runs ``fused_mlp_block_plain``, on CUDA tensors the hand-written kernel in
``csrc/block_mlp.cu`` (two launches of the shared GEMM template; see the note
there). Device dispatch is the op library's: a CUDA tensor launches the
kernel or raises, it never falls back to the plain version.

Both compute what the TPU kernel computes, with its rounding points:
fast-variance LayerNorm in f32, ``y2`` rounded to bf16, bf16 × bf16 products
accumulated in f32 with the bias added in f32, ``h`` rounded to bf16, the
Abramowitz–Stegun erf GELU on the rounded ``h``, ``g`` rounded to bf16, and
the residual epilogue in f32 cast once to ``x.dtype``.

Weights are in the ``nn.Linear`` layout: ``w1`` (Dh, D), ``w2`` (D, Dh).
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from . import _cuda

_SQRT_2 = math.sqrt(2.0)
_GEMM_TILE = 64  # csrc/gemm.cuh BN (a multiple of its depth tile BK = 32)


def _erf_as(x: Tensor) -> Tensor:
    """erf via Abramowitz–Stegun 7.1.26 — the TPU kernel's polynomial."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    y = 1.0 - ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t * torch.exp(-ax * ax)
    return torch.where(x < 0, -y, y)


def gelu_as(h: Tensor) -> Tensor:
    return 0.5 * h * (1.0 + _erf_as(h / _SQRT_2))


def ln_f32(x: Tensor, eps: float) -> Tensor:
    """Fast-variance LayerNorm without affine, f32 (the kernels' ``_ln_f32``)."""
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + eps)


def bf16_linear(a: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """bf16 × bf16 product accumulated in f32, f32 bias: ``a`` is bf16, ``w``
    is (out, in) in any float type and rounded to bf16 first."""
    return a.float() @ w.to(torch.bfloat16).float().t() + b.float()


def residual_epilogue(
    x: Tensor, residual: Tensor | None, proj: Tensor, ls_gamma: Tensor | None,
    dp_scale: Tensor | None,
) -> Tensor:
    """``(r + dp·γ_ls·proj)`` in f32, cast to ``x.dtype`` (both kernels)."""
    r = (x if residual is None else residual).float()
    if ls_gamma is None and dp_scale is None:
        return (r + proj).to(x.dtype)
    scale = dp_scale.float().reshape(-1, 1, 1) if dp_scale is not None else 1.0
    if ls_gamma is not None:
        scale = scale * ls_gamma.float()
    return (r + scale * proj).to(x.dtype)


def fused_mlp_block_plain(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
    b2: Tensor, ls_gamma: Tensor | None = None, dp_scale: Tensor | None = None,
    residual: Tensor | None = None, eps: float = 1e-6,
) -> Tensor:
    """Plain PyTorch version of the kernel, same rounding points."""
    y2 = (ln_f32(x.float(), eps) * ln_scale.float() + ln_bias.float()).to(torch.bfloat16)
    h = bf16_linear(y2, w1, b1).to(torch.bfloat16)
    g = gelu_as(h.float()).to(torch.bfloat16)
    return residual_epilogue(x, residual, bf16_linear(g, w2, b2), ls_gamma, dp_scale)


def use_fused_mlp(d_model: int, hidden: int, dropout: float) -> bool:
    """Shape rule of the CUDA kernel: both widths fill whole 64-column GEMM
    tiles (every ViT and DeiT width does). No dropout: the kernel has none."""
    return dropout == 0.0 and d_model % _GEMM_TILE == 0 and hidden % _GEMM_TILE == 0


def fused_mlp_block_cuda(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
    b2: Tensor, ls_gamma: Tensor | None, dp_scale: Tensor | None,
    residual: Tensor | None, eps: float,
) -> Tensor:
    """Launch ``csrc/block_mlp.cu`` on the current stream."""
    B, T, D = x.shape
    Dh = w1.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_mlp_block: x must be float32 or bfloat16, got {x.dtype}")
    if w1.shape != (Dh, D) or w2.shape != (D, Dh):
        raise ValueError(f"fused_mlp_block: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} "
                         f"do not match d_model={D} in the (out, in) layout")
    if not use_fused_mlp(D, Dh, 0.0):
        raise ValueError(f"fused_mlp_block: no CUDA kernel for d_model={D}, hidden={Dh}; "
                         "gate calls with use_fused_mlp()")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError("fused_mlp_block: residual must match x in shape and dtype")
    x = x.contiguous()
    res = x if residual is None else residual.contiguous()
    w1b = w1.to(torch.bfloat16).contiguous()
    w2b = w2.to(torch.bfloat16).contiguous()
    dp = None if dp_scale is None else dp_scale.float().contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    g = torch.empty(B * T, Dh, dtype=torch.bfloat16, device=x.device)  # hidden activation
    with torch.cuda.device(x.device):
        lib = _cuda.lib()
        err = lib.vtt_block_mlp_fwd(
            _cuda.ptr(x), _cuda.ptr(res), _cuda.ptr(out), _cuda.ptr(g),
            int(x.dtype == torch.bfloat16),
            *_cuda.vec(ln_scale.contiguous()), *_cuda.vec(ln_bias.contiguous()),
            _cuda.ptr(w1b), *_cuda.vec(b1.contiguous()),
            _cuda.ptr(w2b), *_cuda.vec(b2.contiguous()),
            *_cuda.vec(None if ls_gamma is None else ls_gamma.contiguous()), _cuda.ptr(dp),
            B * T, T, D, Dh, float(eps), _cuda.stream(),
        )
        _cuda.check(err, "fused_mlp_block")
    _cuda.LAUNCHES["block_mlp"] += 1
    return out


@torch.library.custom_op("vtt::fused_mlp_block", mutates_args=(), device_types="cpu")
def _fused_mlp_op(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
    b2: Tensor, ls_gamma: Tensor | None, dp_scale: Tensor | None,
    residual: Tensor | None, eps: float,
) -> Tensor:
    return fused_mlp_block_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale,
                                 residual, eps)


_fused_mlp_op.register_kernel("cuda")(fused_mlp_block_cuda)


@_fused_mlp_op.register_fake
def _(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale, residual, eps):
    return torch.empty_like(x)


def fused_mlp_block(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
    b2: Tensor, ls_gamma: Tensor | None = None, dp_scale: Tensor | None = None, *,
    residual: Tensor | None = None, eps: float = 1e-6,
) -> Tensor:
    """``r + dp·γ_ls·(gelu(LN(x)·W1ᵀ+b1)·W2ᵀ+b2)``; x: (B, T, D), w1: (Dh, D),
    w2: (D, Dh), dp_scale: (B, 1) per-sample drop-path scale or None."""
    return _fused_mlp_op(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale, residual,
                         float(eps))
