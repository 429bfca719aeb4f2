"""Fused transformer MLP half-block (K3 forward and backward) — port of
``vision_toolbox_tpu/ops/block_mlp.py``.

``out = r + dp·γ_ls·(gelu(LN(x)·W1ᵀ + b1)·W2ᵀ + b2)`` with ``r`` the
separate ``residual`` if given, else ``x``.

``fused_mlp_block`` is the entry point. Without gradients (serving,
``torch.export``) it runs the custom op ``vtt::fused_mlp_block``: on CPU
tensors ``fused_mlp_block_plain``, on CUDA tensors the hand-written kernels in
``csrc/block_mlp.cu`` (the LayerNorm row pass and two launches of the shared
wgmma GEMM template; see the note there). Under autograd it runs
``FusedMLPFunction``: the backward-save forward and the backward kernels
``csrc/block_mlp_bwd.cu`` on CUDA tensors,
their plain versions (``fused_mlp_save_plain``, ``fused_mlp_bwd_plain``) on
CPU tensors, or on any device with ``plain=True``. A CUDA tensor launches
the kernels or raises; nothing falls back to the plain versions.

Both compute what the TPU kernels compute, with their rounding points.
Forward: fast-variance LayerNorm in f32, ``y2`` rounded to bf16, bf16 × bf16
products accumulated in f32 with the bias added in f32, ``h`` rounded to
bf16, the Abramowitz–Stegun erf GELU on the rounded ``h``, ``g`` rounded to
bf16, the residual epilogue in f32 cast once to ``x.dtype``. Backward
(``_bwd_kernel``): ``douts = dout·dp·γ_ls`` in f32 (its column sum is db2)
rounded to bf16, ``dh = bf16(douts·W2 ⊙ gelu'(h))`` (db1 from the f32
values), ``dy2 = dh·W1`` in f32, the LayerNorm backward from the saved bf16
``xhat`` and f32 ``rstd``. The weight gradients are plain products outside
the kernel, as XLA computes them in the JAX package (``_fused_mlp_bwd``):
``dW1 = dhᵀ·y2``, ``dW2 = doutsᵀ·g`` with ``douts = dout·(dp·γ_ls)`` in
``dout``'s type, both accumulated in f32 and rounded to bf16, the kernel's
weight type (in a sharded step over a data axis above 1, after the ranks'
f32 sums are all-reduced, as GSPMD reduces before JAX's cast); every
gradient comes back in its operand's dtype.

Weights are in the ``nn.Linear`` layout: ``w1`` (Dh, D), ``w2`` (D, Dh).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor

from ..parallel.mesh import reduced_bf16
from . import _cuda

_SQRT_2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_AS = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429, 0.3275911)
_GEMM_WIDTH_STEP = 32  # csrc/gemm.cuh: the narrowest column tile; widths and depths % 32
# rows a partial row of column sums covers: csrc/block_bwd.cuh DOUTS_ROWS and
# LN_ROWS, csrc/gemm.cuh BM (a GEMM row tile)
_DOUTS_ROWS, _LN_ROWS, _GEMM_ROWS = 64, 32, 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bwd_partial_floats(m: int, d: int, dh: int) -> int:
    """Floats of the backward's f32 scratch of column-sum partial rows
    (``csrc/block_mlp_bwd.cu`` ``partial_floats``, the C entry
    ``vtt_block_mlp_bwd_partial_floats``): db2 and dγ_ls a row per
    64 rows, db1 a row per 128-row GEMM tile, dγ_ln and dβ_ln a row per 32."""
    return (2 * _cdiv(m, _DOUTS_ROWS) * d + _cdiv(m, _GEMM_ROWS) * dh
            + 2 * _cdiv(m, _LN_ROWS) * d)


def _erf_as(x: Tensor) -> tuple[Tensor, Tensor]:
    """erf via Abramowitz–Stegun 7.1.26 — the TPU kernel's polynomial — and
    its exp(−x²)."""
    a1, a2, a3, a4, a5, p = _AS
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    e = torch.exp(-ax * ax)
    y = 1.0 - ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t * e
    return torch.where(x < 0, -y, y), e


def gelu_as(h: Tensor) -> Tensor:
    return 0.5 * h * (1.0 + _erf_as(h / _SQRT_2)[0])


def gelu_grad_as(h: Tensor) -> Tensor:
    """gelu'(h) = Φ(h) + h·φ(h) with the same polynomial (``_gelu_grad_f32``)."""
    erf, e = _erf_as(h * (1.0 / _SQRT_2))
    return 0.5 * (1.0 + erf) + h * e * _INV_SQRT_2PI


def ln_stats(x: Tensor, eps: float) -> tuple[Tensor, Tensor]:
    """Fast-variance LayerNorm without affine, f32 (the kernels' ``_ln_f32``):
    (xhat, rstd)."""
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + eps)
    return (x - mu) * rstd, rstd


def bf16_linear(a: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """bf16 × bf16 product accumulated in f32, f32 bias: ``a`` is bf16, ``w``
    is (out, in) in any float type and rounded to bf16 first."""
    return a.float() @ w.to(torch.bfloat16).float().t() + b.float()


def bf16_matmul(a: Tensor, w: Tensor) -> Tensor:
    """``a·w`` (w not transposed: contracting its out dimension), bf16
    operands, f32 accumulation — the backward kernels' products."""
    return a.float() @ w.to(torch.bfloat16).float()


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


def scaled_cotangent(dout: Tensor, ls_gamma: Tensor | None, dp_scale: Tensor | None,
                     saved_proj: Tensor | None) -> tuple[Tensor, Tensor, Tensor | None]:
    """The backward kernels' first step: ``douts = dout·dp·γ_ls`` in f32, its
    column sum (the bias gradient of the projection) and, with γ_ls,
    ``Σ dout·dp·saved_proj`` (its gradient)."""
    d = dout.float()
    if dp_scale is not None:
        d = d * dp_scale.float().reshape(-1, 1, 1)
    douts = d * ls_gamma.float() if ls_gamma is not None else d
    dls = None if ls_gamma is None else (d * saved_proj.float()).sum((0, 1))
    return douts, douts.sum((0, 1)), dls


def xla_douts(dout: Tensor, ls_gamma: Tensor | None, dp_scale: Tensor | None) -> Tensor:
    """``dout·(dp·γ_ls)`` in ``dout``'s type: the operand XLA gives the
    weight-gradient product of the projection (``_fused_*_bwd``)."""
    if ls_gamma is None and dp_scale is None:
        return dout
    s = dp_scale.float().reshape(-1, 1, 1) if dp_scale is not None else 1.0
    if ls_gamma is not None:
        s = s * ls_gamma.float()
    return dout * s.to(dout.dtype)


def layer_norm_bwd(dy: Tensor, xhat: Tensor, rstd: Tensor, ln_scale: Tensor,
                   dout: Tensor | None) -> tuple[Tensor, Tensor, Tensor]:
    """LayerNorm backward from the saves, f32: (dx, dγ_ln, dβ_ln), with
    ``dout`` added to dx when the residual is the LN input."""
    xh = xhat.float()
    dxh = dy * ln_scale.float()
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xh).mean(-1, keepdim=True)
    dx = rstd * (dxh - m1 - xh * m2)
    if dout is not None:
        dx = dout.float() + dx
    return dx, (dy * xh).sum((0, 1)), dy.sum((0, 1))


def weight_grad(a: Tensor, b: Tensor, like: Tensor) -> Tensor:
    """``aᵀ·b`` over all rows, accumulated in f32 and rounded to bf16 (the
    kernels' weight type), returned in ``like.dtype``; in a sharded step
    over a data axis above 1, rounded after the ranks' sums are reduced
    (``parallel/mesh.reduced_bf16``: ``like`` is the weight whose gradient
    this is)."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        # an f32 output: a bf16 one would let cuBLAS reduce split-K partials in bf16
        g = torch.mm(a.t(), b, out_dtype=torch.float32)
    else:
        g = a.float().t() @ b.float()
    return reduced_bf16(g, like).to(like.dtype)


class MLPSaves(NamedTuple):
    """What the backward needs from the forward (JAX ``_run_mlp(save=True)``):
    xhat (B, T, D) bf16, rstd (B, T, 1) f32, h and g (B, T, Dh) bf16, and
    mlpout (B, T, D) bf16 with γ_ls, else None."""

    xhat: Tensor
    rstd: Tensor
    h: Tensor
    g: Tensor
    mlpout: Tensor | None


class MLPGrads(NamedTuple):
    """The in-kernel part of the backward (JAX ``_bwd_kernel``): dx (x's
    type), dh (bf16), and f32 db1, db2, dγ_ln, dβ_ln, dγ_ls (None without
    γ_ls)."""

    dx: Tensor
    dh: Tensor
    db1: Tensor
    db2: Tensor
    dln_scale: Tensor
    dln_bias: Tensor
    dls: Tensor | None


def fused_mlp_save_plain(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
    b2: Tensor, ls_gamma: Tensor | None = None, dp_scale: Tensor | None = None,
    residual: Tensor | None = None, eps: float = 1e-6,
) -> tuple[Tensor, MLPSaves]:
    """Plain PyTorch version of the backward-save forward kernel."""
    xhat, rstd = ln_stats(x.float(), eps)
    y2 = (xhat * ln_scale.float() + ln_bias.float()).to(torch.bfloat16)
    h = bf16_linear(y2, w1, b1).to(torch.bfloat16)
    g = gelu_as(h.float()).to(torch.bfloat16)
    proj = bf16_linear(g, w2, b2)
    out = residual_epilogue(x, residual, proj, ls_gamma, dp_scale)
    mlpout = None if ls_gamma is None else proj.to(torch.bfloat16)
    return out, MLPSaves(xhat.to(torch.bfloat16), rstd, h, g, mlpout)


def fused_mlp_block_plain(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
    b2: Tensor, ls_gamma: Tensor | None = None, dp_scale: Tensor | None = None,
    residual: Tensor | None = None, eps: float = 1e-6,
) -> Tensor:
    """Plain PyTorch version of the inference kernel, same rounding points."""
    return fused_mlp_save_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale,
                                residual, eps)[0]


def fused_mlp_bwd_plain(
    dout: Tensor, saves: MLPSaves, w1: Tensor, w2: Tensor, ln_scale: Tensor,
    ls_gamma: Tensor | None, dp_scale: Tensor | None, has_residual: bool,
) -> MLPGrads:
    """Plain PyTorch version of the backward kernel, same rounding points."""
    douts, db2, dls = scaled_cotangent(dout, ls_gamma, dp_scale, saves.mlpout)
    dh = bf16_matmul(douts.to(torch.bfloat16), w2) * gelu_grad_as(saves.h.float())
    dhb = dh.to(torch.bfloat16)
    dy2 = bf16_matmul(dhb, w1)
    dx, dlns, dlnb = layer_norm_bwd(dy2, saves.xhat, saves.rstd, ln_scale,
                                    None if has_residual else dout)
    return MLPGrads(dx.to(dout.dtype), dhb, dh.sum((0, 1)), db2, dlns, dlnb, dls)


# The JAX rule's admission terms, copied from vision_toolbox_tpu/ops/block_mlp.py
# (``_pick_hidden_tile``, ``_hidden_splits``, ``_chunk_plan``, ``_row_chunk``
# and the two row budgets of ``use_fused_mlp``): TPU VMEM budgets for the
# resident weights and the f32 row scratches. The port's kernels stream
# their weights and never split; the plan only decides which shapes the
# fused half-block takes, so that the port rounds where the reference rounds.
_RESIDENT_BUDGET = 10 * 1024 * 1024
_ROW_BUDGET = 2 * 1024 * 1024  # f32 (T, D) row scratches
_GELU_BUDGET = 8 * 1024 * 1024  # f32 (T, hidden tile) GELU temporaries


def _pick_hidden_tile(dh: int) -> int:
    if dh <= 3072:
        return dh
    for ht in (1536, 1024, 768, 512, 384, 256, 128):
        if dh % ht == 0:
            return ht
    return dh


def _hidden_splits(d_model: int, hidden: int) -> int:
    """Hidden slices of the JAX plan (1, 2 or 4), 0 where there is none:
    ViT-Ti/S/B take 1, ViT-L 2, ViT-H 4."""
    for ns in (1, 2, 4):
        if (hidden % ns == 0 and 2 * d_model * (hidden // ns) * 2 <= _RESIDENT_BUDGET
                and _pick_hidden_tile(hidden // ns) <= 3072):
            return ns
    return 0


def _row_chunk(t: int, target: int) -> int:
    """Smallest k dividing t with t / k ≤ target (1 if t fits, or t is a
    prime above it)."""
    if t <= target:
        return 1
    for k in range(2, t + 1):
        if t % k == 0 and t // k <= target:
            return k
    return 1


def _chunk_plan(t: int, d: int, heavy: bool) -> int:
    light = not heavy and t * d * 4 <= _ROW_BUDGET
    return _row_chunk(t, 3136 if light else 512)


def use_fused_mlp(d_model: int, hidden: int, t: int, dropout: float, has_res: bool = False,
                  has_ls: bool = False) -> bool:
    """Whether a block takes the fused half-block on T tokens (an image or a
    flattened feature map), with a separate residual and LayerScale as
    flagged: the JAX package's rule without its TPU test (no dropout,
    d_model % 32, a hidden-split plan, the row chunk's f32 scratches within
    their budgets), and the CUDA kernels' own term, hidden % 32 (the GEMM's
    32-column tiles; every registered width has it)."""
    ns = _hidden_splits(d_model, hidden)
    if ns == 0 or dropout != 0.0 or d_model % _GEMM_WIDTH_STEP or hidden % _GEMM_WIDTH_STEP:
        return False
    t_eff = t // _chunk_plan(t, d_model, heavy=has_res or has_ls or ns > 1)
    return (t_eff * d_model * 4 <= _ROW_BUDGET
            and t_eff * _pick_hidden_tile(hidden // ns) * 4 <= _GELU_BUDGET)


def _check_cuda_args(x: Tensor, w1: Tensor, w2: Tensor, residual: Tensor | None) -> None:
    D, Dh = x.shape[-1], w1.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_mlp_block: x must be float32 or bfloat16, got {x.dtype}")
    if w1.shape != (Dh, D) or w2.shape != (D, Dh):
        raise ValueError(f"fused_mlp_block: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} "
                         f"do not match d_model={D} in the (out, in) layout")
    if D % _GEMM_WIDTH_STEP or Dh % _GEMM_WIDTH_STEP:
        raise ValueError(f"fused_mlp_block: no CUDA kernel for d_model={D}, hidden={Dh}; "
                         "gate calls with use_fused_mlp()")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError("fused_mlp_block: residual must match x in shape and dtype")


def _mlp_fwd_cuda(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
    b2: Tensor, ls_gamma: Tensor | None, dp_scale: Tensor | None, residual: Tensor | None,
    eps: float, save: bool,
) -> tuple[Tensor, MLPSaves | None]:
    """Launch ``csrc/block_mlp.cu`` on the current stream; with ``save`` also
    write the backward's saves."""
    B, T, D = x.shape
    Dh = w1.shape[0]
    _check_cuda_args(x, w1, w2, residual)
    x = x.contiguous()
    res = x if residual is None else residual.contiguous()
    w1b = w1.to(torch.bfloat16).contiguous()
    w2b = w2.to(torch.bfloat16).contiguous()
    dp = None if dp_scale is None else dp_scale.float().contiguous()
    out = torch.empty_like(x)
    g = torch.empty(B, T, Dh, dtype=torch.bfloat16, device=x.device)  # hidden activation
    y = torch.empty(B, T, D, dtype=torch.bfloat16, device=x.device)  # LN(x)·γ + β, scratch
    saves = None
    if save:
        bf = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device=x.device)
        saves = MLPSaves(bf(B, T, D), torch.empty(B, T, 1, device=x.device), bf(B, T, Dh), g,
                         None if ls_gamma is None else bf(B, T, D))
    if x.numel() == 0:
        return out, saves
    vec = lambda t: _cuda.vec(None if t is None else t.contiguous())
    ptr = lambda t: None if saves is None else _cuda.ptr(t)
    with torch.cuda.device(x.device):
        err = _cuda.lib().vtt_block_mlp_fwd(
            _cuda.ptr(x), _cuda.ptr(res), _cuda.ptr(out), _cuda.ptr(g),
            int(x.dtype == torch.bfloat16), *vec(ln_scale), *vec(ln_bias),
            _cuda.ptr(w1b), *vec(b1), _cuda.ptr(w2b), *vec(b2), *vec(ls_gamma), _cuda.ptr(dp),
            *(ptr(getattr(saves, n, None)) for n in ("xhat", "rstd", "h", "mlpout")),
            _cuda.ptr(y), B * T, T, D, Dh, float(eps), _cuda.stream(),
        )
        _cuda.check(err, "fused_mlp_block")
    _cuda.LAUNCHES["block_mlp"] += 1
    return out, saves


def fused_mlp_block_cuda(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
    b2: Tensor, ls_gamma: Tensor | None, dp_scale: Tensor | None,
    residual: Tensor | None, eps: float,
) -> Tensor:
    """The inference kernel: writes ``out`` and none of the saves."""
    return _mlp_fwd_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale, residual,
                         eps, save=False)[0]


def fused_mlp_save_cuda(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
    b2: Tensor, ls_gamma: Tensor | None = None, dp_scale: Tensor | None = None,
    residual: Tensor | None = None, eps: float = 1e-6,
) -> tuple[Tensor, MLPSaves]:
    """The backward-save forward kernel: ``out`` and the saves."""
    return _mlp_fwd_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale, residual,
                         eps, save=True)


def fused_mlp_bwd_cuda(
    dout: Tensor, saves: MLPSaves, w1: Tensor, w2: Tensor, ln_scale: Tensor,
    ls_gamma: Tensor | None, dp_scale: Tensor | None, has_residual: bool,
) -> MLPGrads:
    """Launch ``csrc/block_mlp_bwd.cu`` on the current stream."""
    B, T, D = dout.shape
    Dh = w1.shape[0]
    if dout.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_mlp_block backward: dout must be float32 or bfloat16, "
                        f"got {dout.dtype}")
    if saves.h.shape != (B, T, Dh) or saves.xhat.shape != dout.shape:
        raise ValueError("fused_mlp_block backward: saves do not match dout")
    _check_cuda_args(dout, w1, w2, None)
    dout = dout.contiguous()
    w1b = w1.to(torch.bfloat16).contiguous()
    w2b = w2.to(torch.bfloat16).contiguous()
    dp = None if dp_scale is None else dp_scale.float().contiguous()
    dev = dout.device
    # column sums, written whole by the kernels' fixed-order sum (zero over no rows)
    f32 = lambda n: (torch.empty if dout.numel() else torch.zeros)(n, device=dev)
    dh = torch.empty(B, T, Dh, dtype=torch.bfloat16, device=dev)
    grads = MLPGrads(torch.empty_like(dout), dh, f32(Dh), f32(D), f32(D), f32(D),
                     None if ls_gamma is None else f32(D))
    if dout.numel() == 0:
        return grads
    douts = torch.empty(B, T, D, dtype=torch.bfloat16, device=dev)
    dy2 = torch.empty(B, T, D, device=dev)
    partials = torch.empty(_bwd_partial_floats(B * T, D, Dh), device=dev)
    vec = lambda t: _cuda.vec(None if t is None else t.contiguous())
    with torch.cuda.device(dev):
        err = _cuda.lib().vtt_block_mlp_bwd(
            _cuda.ptr(dout), int(dout.dtype == torch.bfloat16), _cuda.ptr(saves.xhat),
            _cuda.ptr(saves.rstd), _cuda.ptr(saves.h), _cuda.ptr(saves.mlpout),
            _cuda.ptr(w1b), _cuda.ptr(w2b), *vec(ln_scale), *vec(ls_gamma), _cuda.ptr(dp),
            _cuda.ptr(grads.dx), _cuda.ptr(grads.dh), _cuda.ptr(douts), _cuda.ptr(dy2),
            *(_cuda.ptr(t) for t in grads[2:]), _cuda.ptr(partials), partials.numel(),
            int(has_residual), B * T, T, D, Dh, _cuda.stream(),
        )
        _cuda.check(err, "fused_mlp_block backward")
    _cuda.LAUNCHES["block_mlp_bwd"] += 1
    return grads


def fused_mlp_vjp(
    dout: Tensor, saves: MLPSaves, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor,
    w2: Tensor, b2: Tensor, ls_gamma: Tensor | None, dp_scale: Tensor | None,
    has_residual: bool, plain: bool = False,
) -> tuple[Tensor | None, ...]:
    """Cotangents of (x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma,
    residual), each in its operand's dtype (JAX ``_fused_mlp_bwd``): the
    backward kernel on CUDA tensors (its plain version on CPU tensors or with
    ``plain``), then the weight-gradient products."""
    bwd = fused_mlp_bwd_plain if plain or not dout.is_cuda else fused_mlp_bwd_cuda
    gr = bwd(dout, saves, w1, w2, ln_scale, ls_gamma, dp_scale, has_residual)
    y2 = (saves.xhat.float() * ln_scale.float() + ln_bias.float()).to(torch.bfloat16)
    return (
        gr.dx, gr.dln_scale.to(ln_scale.dtype), gr.dln_bias.to(ln_bias.dtype),
        weight_grad(gr.dh, y2, w1), gr.db1.to(b1.dtype),
        weight_grad(xla_douts(dout, ls_gamma, dp_scale), saves.g, w2), gr.db2.to(b2.dtype),
        None if ls_gamma is None else gr.dls.to(ls_gamma.dtype),
        dout if has_residual else None,
    )


class FusedMLPFunction(torch.autograd.Function):
    """The differentiable half-block: the backward-save forward, then
    ``fused_mlp_vjp``. The kernels run on CUDA tensors, their plain versions
    on CPU tensors or with ``plain``."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale, residual, eps,
                plain):
        fwd = fused_mlp_save_plain if plain or not x.is_cuda else fused_mlp_save_cuda
        out, saves = fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale, residual, eps)
        ctx.save_for_backward(*saves, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale)
        ctx.plain, ctx.has_residual = plain, residual is not None
        return out

    @staticmethod
    def backward(ctx, dout):
        *saves, lns, lnb, w1, b1, w2, b2, ls, dp = ctx.saved_tensors
        g = fused_mlp_vjp(dout, MLPSaves(*saves), lns, lnb, w1, b1, w2, b2, ls, dp,
                          ctx.has_residual, ctx.plain)
        return (*g[:8], None, g[8], None, None)


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
    residual: Tensor | None = None, eps: float = 1e-6, plain: bool = False,
) -> Tensor:
    """``r + dp·γ_ls·(gelu(LN(x)·W1ᵀ+b1)·W2ᵀ+b2)``; x: (B, T, D), w1: (Dh, D),
    w2: (D, Dh), dp_scale: (B, 1) per-sample drop-path scale or None.
    Differentiable; ``plain`` runs the plain PyTorch versions on any device
    (for checking the kernels)."""
    operands = (x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        return FusedMLPFunction.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale,
                                      residual, float(eps), plain)
    if plain:
        return fused_mlp_block_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale,
                                     residual, float(eps))
    return _fused_mlp_op(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, dp_scale, residual,
                         float(eps))
