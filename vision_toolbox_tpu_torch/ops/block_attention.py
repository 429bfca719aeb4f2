"""Fused transformer self-attention half-block (K4 forward and backward) —
port of ``vision_toolbox_tpu/ops/block_attention.py``.

``out = x + dp·γ_ls·(MHA(LN(x))·Woᵀ + bo)``, unbiased multi-head
self-attention per image with q/k/v projected from the LayerNorm output.

``fused_attention_block`` is the entry point. Without gradients (serving,
``torch.export``) it runs the custom op ``vtt::fused_attention_block``: on
CPU tensors ``fused_attention_block_plain``, on CUDA tensors the hand-written
kernels in ``csrc/block_attention.cu`` (LN+q/k/v projection, attention,
out-projection+epilogue; see the note there). Under autograd it runs
``FusedAttentionFunction``: the backward-save forward and the backward
kernels ``csrc/block_attention_bwd.cu`` on CUDA tensors, their plain versions
on CPU tensors, or on any device with ``plain=True``. A CUDA tensor launches
the kernels or raises.

Rounding points are the TPU kernels'. Forward: fast-variance LayerNorm in
f32, ``y`` rounded to bf16, q/k/v = bf16(y·Wᵀ + b) with f32 accumulation and
f32 bias, logits and softmax in f32 (max subtracted), ``p`` rounded to bf16,
``o = p·v`` accumulated in f32 and rounded to bf16, the out-projection
accumulated in f32, and the residual epilogue in f32 cast once to
``x.dtype``. Backward (``_bwd_kernel``, from the saved ``p``, no softmax
recompute): ``douts = dout·dp·γ_ls`` in f32 rounded to bf16,
``do = bf16(douts·Wo)``, ``dv = pᵀ·do``, ``ds = bf16(p ⊙ (do·vᵀ −
rowsum))``, ``dq = ds·k·scale``, ``dk = dsᵀ·bf16(q·scale)`` (bias gradients
from the f32 values, then rounded to bf16), ``dy = dq·Wq + dk·Wk + dv·Wv`` in
f32 and the LayerNorm backward. The weight gradients are plain products
outside the kernel, as XLA computes them (``_fused_attn_bwd``). Weights are
in the ``nn.Linear`` layout (D_out, D_in).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from . import _cuda
from .block_mlp import (
    bf16_linear,
    bf16_matmul,
    layer_norm_bwd,
    ln_stats,
    residual_epilogue,
    scaled_cotangent,
    weight_grad,
    xla_douts,
)

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
    vit_b_16 at 224 px (T=197, head_dim 64) takes 75.5 KB. The backward
    kernels cover every shape this admits (they stream keys and queries in
    tiles)."""
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


class AttnSaves(NamedTuple):
    """What the backward needs from the forward (JAX ``_run_attn(save=True)``):
    xhat (B, T, D) bf16, rstd (B, T, 1) f32, q, k, v, o (B, T, D) bf16, the
    softmax probabilities p (B, H, T, T) bf16, and proj (B, T, D) bf16 with
    γ_ls, else None."""

    xhat: Tensor
    rstd: Tensor
    q: Tensor
    k: Tensor
    v: Tensor
    o: Tensor
    p: Tensor
    proj: Tensor | None


class AttnGrads(NamedTuple):
    """The in-kernel part of the backward (JAX ``_bwd_kernel``): dx (x's
    type), dq, dk, dv (bf16), and f32 dbq, dbk, dbv, dbo, dγ_ln, dβ_ln, dγ_ls
    (None without γ_ls)."""

    dx: Tensor
    dq: Tensor
    dk: Tensor
    dv: Tensor
    dbq: Tensor
    dbk: Tensor
    dbv: Tensor
    dbo: Tensor
    dln_scale: Tensor
    dln_bias: Tensor
    dls: Tensor | None


def _heads(t: Tensor, n_heads: int) -> Tensor:
    """(B, T, D) → (B, H, T, hd) f32."""
    B, T, D = t.shape
    return t.float().reshape(B, T, n_heads, D // n_heads).transpose(1, 2)


def _merge(t: Tensor) -> Tensor:
    """(B, H, T, hd) → (B, T, D)."""
    B, H, T, hd = t.shape
    return t.transpose(1, 2).reshape(B, T, H * hd)


def fused_attention_save_plain(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, wq: Tensor, bq: Tensor, wk: Tensor,
    bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, n_heads: int,
    ls_gamma: Tensor | None = None, dp_scale: Tensor | None = None, eps: float = 1e-6,
) -> tuple[Tensor, AttnSaves]:
    """Plain PyTorch version of the backward-save forward kernels."""
    hd = x.shape[-1] // n_heads
    xhat, rstd = ln_stats(x.float(), eps)
    y = (xhat * ln_scale.float() + ln_bias.float()).to(torch.bfloat16)
    q, k, v = (bf16_linear(y, w, b).to(torch.bfloat16) for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    logits = (_heads(q, n_heads) * hd**-0.5) @ _heads(k, n_heads).transpose(-1, -2)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16)
    o = _merge(p.float() @ _heads(v, n_heads)).to(torch.bfloat16)
    proj = bf16_linear(o, wo, bo)
    out = residual_epilogue(x, None, proj, ls_gamma, dp_scale)
    return out, AttnSaves(xhat.to(torch.bfloat16), rstd, q, k, v, o, p,
                          None if ls_gamma is None else proj.to(torch.bfloat16))


def fused_attention_block_plain(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, wq: Tensor, bq: Tensor, wk: Tensor,
    bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, n_heads: int,
    ls_gamma: Tensor | None = None, dp_scale: Tensor | None = None, eps: float = 1e-6,
) -> Tensor:
    """Plain PyTorch version of the inference kernels, same rounding points."""
    return fused_attention_save_plain(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                                      n_heads, ls_gamma, dp_scale, eps)[0]


def fused_attention_bwd_plain(
    dout: Tensor, saves: AttnSaves, wq: Tensor, wk: Tensor, wv: Tensor, wo: Tensor,
    ln_scale: Tensor, ls_gamma: Tensor | None, dp_scale: Tensor | None, n_heads: int,
) -> AttnGrads:
    """Plain PyTorch version of the backward kernels, same rounding points."""
    scale = (dout.shape[-1] // n_heads) ** -0.5
    douts, dbo, dls = scaled_cotangent(dout, ls_gamma, dp_scale, saves.proj)
    do = _heads(bf16_matmul(douts.to(torch.bfloat16), wo).to(torch.bfloat16), n_heads)
    p = saves.p.float()
    dv = p.transpose(-1, -2) @ do
    dp = do @ _heads(saves.v, n_heads).transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(torch.bfloat16).float()
    dq = ds @ _heads(saves.k, n_heads) * scale
    dk = ds.transpose(-1, -2) @ (_heads(saves.q, n_heads) * scale).to(torch.bfloat16).float()
    dq, dk, dv = _merge(dq), _merge(dk), _merge(dv)
    bf = [t.to(torch.bfloat16) for t in (dq, dk, dv)]
    dy = bf16_matmul(bf[0], wq) + bf16_matmul(bf[1], wk) + bf16_matmul(bf[2], wv)
    dx, dlns, dlnb = layer_norm_bwd(dy, saves.xhat, saves.rstd, ln_scale, dout)
    return AttnGrads(dx.to(dout.dtype), *bf, dq.sum((0, 1)), dk.sum((0, 1)), dv.sum((0, 1)),
                     dbo, dlns, dlnb, dls)


def _check_cuda_args(x: Tensor, ws: tuple[Tensor, ...], n_heads: int) -> None:
    B, T, D = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention_block: x must be float32 or bfloat16, got {x.dtype}")
    if any(w.shape != (D, D) for w in ws):
        raise ValueError(f"fused_attention_block: weights must be ({D}, {D})")
    if not use_fused_attention(D, n_heads, T, 0.0, True):
        raise ValueError(f"fused_attention_block: no CUDA kernel for d_model={D}, "
                         f"n_heads={n_heads}, t={T}; gate calls with use_fused_attention()")


def _attn_fwd_cuda(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, wq: Tensor, bq: Tensor, wk: Tensor,
    bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, n_heads: int,
    ls_gamma: Tensor | None, dp_scale: Tensor | None, eps: float, save: bool,
) -> tuple[Tensor, AttnSaves | None]:
    """Launch ``csrc/block_attention.cu`` on the current stream; with ``save``
    also write the backward's saves."""
    B, T, D = x.shape
    _check_cuda_args(x, (wq, wk, wv, wo), n_heads)
    x = x.contiguous()
    ws = [w.to(torch.bfloat16).contiguous() for w in (wq, wk, wv, wo)]
    dp = None if dp_scale is None else dp_scale.float().contiguous()
    out = torch.empty_like(x)
    # q, k, v, o: the intermediates that go through device memory
    qkvo = torch.empty(4, B, T, D, dtype=torch.bfloat16, device=x.device)
    saves = None
    if save:
        bf = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device=x.device)
        saves = AttnSaves(bf(B, T, D), torch.empty(B, T, 1, device=x.device), *qkvo,
                          bf(B, n_heads, T, T), None if ls_gamma is None else bf(B, T, D))
    if x.numel() == 0:
        return out, saves
    vec = lambda t: _cuda.vec(None if t is None else t.contiguous())
    ptr = lambda t: None if saves is None else _cuda.ptr(t)
    with torch.cuda.device(x.device):
        err = _cuda.lib().vtt_block_attention_fwd(
            _cuda.ptr(x), _cuda.ptr(out), *(_cuda.ptr(t) for t in qkvo),
            int(x.dtype == torch.bfloat16), *vec(ln_scale), *vec(ln_bias),
            _cuda.ptr(ws[0]), *vec(bq), _cuda.ptr(ws[1]), *vec(bk),
            _cuda.ptr(ws[2]), *vec(bv), _cuda.ptr(ws[3]), *vec(bo),
            *vec(ls_gamma), _cuda.ptr(dp),
            *(ptr(getattr(saves, n, None)) for n in ("xhat", "rstd", "p", "proj")),
            B, T, D, n_heads, float((D // n_heads) ** -0.5), float(eps), _cuda.stream(),
        )
        _cuda.check(err, "fused_attention_block")
    _cuda.LAUNCHES["block_attention"] += 1
    return out, saves


def fused_attention_block_cuda(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, wq: Tensor, bq: Tensor, wk: Tensor,
    bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, n_heads: int,
    ls_gamma: Tensor | None, dp_scale: Tensor | None, eps: float,
) -> Tensor:
    """The inference kernels: write ``out`` and none of the saves."""
    return _attn_fwd_cuda(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, n_heads,
                          ls_gamma, dp_scale, eps, save=False)[0]


def fused_attention_save_cuda(
    x: Tensor, ln_scale: Tensor, ln_bias: Tensor, wq: Tensor, bq: Tensor, wk: Tensor,
    bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, n_heads: int,
    ls_gamma: Tensor | None = None, dp_scale: Tensor | None = None, eps: float = 1e-6,
) -> tuple[Tensor, AttnSaves]:
    """The backward-save forward kernels: ``out`` and the saves."""
    return _attn_fwd_cuda(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, n_heads,
                          ls_gamma, dp_scale, eps, save=True)


def fused_attention_bwd_cuda(
    dout: Tensor, saves: AttnSaves, wq: Tensor, wk: Tensor, wv: Tensor, wo: Tensor,
    ln_scale: Tensor, ls_gamma: Tensor | None, dp_scale: Tensor | None, n_heads: int,
) -> AttnGrads:
    """Launch ``csrc/block_attention_bwd.cu`` on the current stream."""
    B, T, D = dout.shape
    if dout.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention_block backward: dout must be float32 or bfloat16, "
                        f"got {dout.dtype}")
    if saves.p.shape != (B, n_heads, T, T) or saves.q.shape != dout.shape:
        raise ValueError("fused_attention_block backward: saves do not match dout")
    _check_cuda_args(dout, (wq, wk, wv, wo), n_heads)
    dout = dout.contiguous()
    dev = dout.device
    wob = wo.to(torch.bfloat16).contiguous()
    wqkv = torch.cat([w.to(torch.bfloat16) for w in (wq, wk, wv)])  # (3D, D): dy in one product
    dp = None if dp_scale is None else dp_scale.float().contiguous()
    dqkv = torch.empty(B, T, 3 * D, dtype=torch.bfloat16, device=dev)
    f32 = lambda n: torch.zeros(n, device=dev)  # atomically accumulated column sums
    dbqkv, dbo, dlns, dlnb = f32(3 * D), f32(D), f32(D), f32(D)
    dls = None if ls_gamma is None else f32(D)
    dx = torch.empty_like(dout)
    if dout.numel() > 0:
        bf = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device=dev)
        douts, do, ds = bf(B, T, D), bf(B, T, D), bf(B, n_heads, T, T)
        dy = torch.empty(B, T, D, device=dev)
        vec = lambda t: _cuda.vec(None if t is None else t.contiguous())
        with torch.cuda.device(dev):
            err = _cuda.lib().vtt_block_attention_bwd(
                _cuda.ptr(dout), int(dout.dtype == torch.bfloat16), _cuda.ptr(saves.xhat),
                _cuda.ptr(saves.rstd), *(_cuda.ptr(t) for t in saves[2:5]),
                _cuda.ptr(saves.p), _cuda.ptr(saves.proj), _cuda.ptr(wob), _cuda.ptr(wqkv),
                *vec(ln_scale), *vec(ls_gamma), _cuda.ptr(dp),
                _cuda.ptr(dx), _cuda.ptr(dqkv), _cuda.ptr(douts), _cuda.ptr(do), _cuda.ptr(ds),
                _cuda.ptr(dy), _cuda.ptr(dbqkv), _cuda.ptr(dbo), _cuda.ptr(dlns),
                _cuda.ptr(dlnb), _cuda.ptr(dls),
                B, T, D, n_heads, float((D // n_heads) ** -0.5), _cuda.stream(),
            )
            _cuda.check(err, "fused_attention_block backward")
        _cuda.LAUNCHES["block_attention_bwd"] += 1
    return AttnGrads(dx, *dqkv.split(D, dim=-1), *dbqkv.split(D), dbo, dlns, dlnb, dls)


def fused_attention_vjp(
    dout: Tensor, saves: AttnSaves, ln_scale: Tensor, ln_bias: Tensor, wq: Tensor, bq: Tensor,
    wk: Tensor, bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, n_heads: int,
    ls_gamma: Tensor | None, dp_scale: Tensor | None, plain: bool = False,
) -> tuple[Tensor | None, ...]:
    """Cotangents of (x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
    ls_gamma), each in its operand's dtype (JAX ``_fused_attn_bwd``): the
    backward kernels on CUDA tensors (their plain versions on CPU tensors or
    with ``plain``), then the weight-gradient products."""
    bwd = fused_attention_bwd_plain if plain or not dout.is_cuda else fused_attention_bwd_cuda
    gr = bwd(dout, saves, wq, wk, wv, wo, ln_scale, ls_gamma, dp_scale, n_heads)
    y = (saves.xhat.float() * ln_scale.float() + ln_bias.float()).to(torch.bfloat16)
    return (
        gr.dx, gr.dln_scale.to(ln_scale.dtype), gr.dln_bias.to(ln_bias.dtype),
        weight_grad(gr.dq, y, wq), gr.dbq.to(bq.dtype),
        weight_grad(gr.dk, y, wk), gr.dbk.to(bk.dtype),
        weight_grad(gr.dv, y, wv), gr.dbv.to(bv.dtype),
        weight_grad(xla_douts(dout, ls_gamma, dp_scale), saves.o, wo), gr.dbo.to(bo.dtype),
        None if ls_gamma is None else gr.dls.to(ls_gamma.dtype),
    )


class FusedAttentionFunction(torch.autograd.Function):
    """The differentiable half-block: the backward-save forward, then
    ``fused_attention_vjp``. The kernels run on CUDA tensors, their plain
    versions on CPU tensors or with ``plain``."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, n_heads, ls_gamma,
                dp_scale, eps, plain):
        fwd = fused_attention_save_plain if plain or not x.is_cuda else fused_attention_save_cuda
        out, saves = fwd(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, n_heads,
                         ls_gamma, dp_scale, eps)
        ctx.save_for_backward(*saves, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                              ls_gamma, dp_scale)
        ctx.plain, ctx.n_heads = plain, n_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        *saves, lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo, ls, dp = ctx.saved_tensors
        g = fused_attention_vjp(dout, AttnSaves(*saves), lns, lnb, wq, bq, wk, bk, wv, bv, wo,
                                bo, ctx.n_heads, ls, dp, ctx.plain)
        return (*g[:11], None, g[11], None, None, None)


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
    plain: bool = False,
) -> Tensor:
    """``x + dp·γ_ls·(MHA(LN(x))·Woᵀ + bo)``; x: (B, T, D), all w (D, D) in
    the (out, in) layout, dp_scale: (B, 1) per-sample drop-path scale or None.
    Differentiable; ``plain`` runs the plain PyTorch versions on any device
    (for checking the kernels)."""
    args = (x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, int(n_heads), ls_gamma,
            dp_scale, float(eps))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args[:11] + (ls_gamma,)):
        return FusedAttentionFunction.apply(*args, plain)
    if plain:
        return fused_attention_block_plain(*args)
    return _fused_attn_op(*args)
