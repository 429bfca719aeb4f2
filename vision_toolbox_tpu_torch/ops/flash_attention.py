"""Flash attention (K6 forward and backward) — port of
``vision_toolbox_tpu/ops/flash_attention.py``.

softmax(q·kᵀ·scale + bias)·v for long sequences, scale = head_dim**-0.5,
with O(T) memory: the forward saves only the output and the per-row
logsumexp ``lse``; the backward recomputes p = exp(q·kᵀ·scale − lse) tile by
tile (FlashAttention-2: dK/dV per key tile, dQ per query tile), so no
(T, S) tensor goes to device memory in training or inference.

``flash_attention`` is the entry point, on the (B, T, N, H) layout; like the
JAX package it relays the operands out to (B·N, T, H) (and the bias, which
broadcasts against (B, N, T, S), to (B·N, T, S)); on CUDA tensors that copy
zero-pads the head to the kernels' 16-column step, with the true width's
scale passed along and the output sliced back. Heads up to 256 run: above
128 the kernels compute the output (and dq, dk, dv) one ≤ 128-wide chunk
of columns at a time. Without gradients
(serving, ``torch.export``) it runs the custom op ``vtt::flash_attention``:
on CPU tensors ``flash_attention_plain``, on CUDA tensors the hand-written
kernel in ``csrc/flash_attention.cu``. Under autograd it runs
``FlashAttentionFunction``, whose unbiased backward is the kernels in
``csrc/flash_attention_bwd.cu`` on CUDA tensors and
``flash_attention_bwd_plain`` on CPU tensors or with ``plain=True``. A CUDA
tensor launches the kernels or raises. The biased backward, whose bias
gradient is (T, S)-sized anyway, is the JAX package's XLA recompute on every
device (``flash_attention_bias_bwd_plain``).

Rounding points are the TPU kernels' (``_flash_fwd_kernel``,
``_flash_bwd_dkv_kernel``, ``_flash_bwd_dq_kernel``): q, k, v (and the
output cotangent) are read in their type and widened to f32; the logits,
the bias, the running max and sum, p, delta = Σ g·out, dp and ds are f32;
the output and dq, dk, dv are rounded once to the input type, lse is f32.
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import _cuda

FLASH_MIN_SEQ = 1024  # ops/flash_attention.py PALLAS_MIN_SEQ
MAX_HEAD_DIM = 256  # csrc/flash_attention.cuh MAX_HEAD_DIM: the widest head whose tiles fit
MAX_PAIRS = 65535  # (batch·head) pairs: the kernels' grid y extent


def use_flash_attention(t: int) -> bool:
    """The JAX package's dispatch rule (``use_pallas``; its caller sends
    attention dropout elsewhere): T ≥ 1024 and a multiple of 128, for any
    head width. siglip vit_b_16 at 512 px (T = 1024) passes; T = 1025 (a cls
    token), 577 (384 px) and the MAP probe (T = 1) do not. On a CUDA tensor
    ``flash_attention`` zero-pads the head to a multiple of 16 (72 runs as
    80), and the kernels take heads up to 256 (above 128 in column chunks);
    a wider head raises in ``flash_attention_cuda``."""
    return t >= FLASH_MIN_SEQ and t % 128 == 0


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None = None,
                          scale: float | None = None) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the forward kernel on (B·N, T, H) operands
    and a (B·N, T, S) bias: (out in q's type, lse (B·N, T, 1) f32). The
    softmax is exact over each whole row; the kernel's running max and sum
    give the same value up to f32 rounding. ``scale`` defaults to H**-0.5."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = (q.float() * scale) @ k.float().transpose(-1, -2)
    if bias is not None:
        logits = logits + bias.float()
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    out = (p @ v.float()) / l
    return out.to(q.dtype), m + torch.log(l)


def flash_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                              g: Tensor, scale: float | None = None
                              ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the unbiased backward kernels
    (``_flash_bwd_pallas``): p recomputed from lse, every intermediate f32,
    dq, dk, dv rounded once to their operands' types."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    g32 = g.float()
    delta = (g32 * out.float()).sum(-1, keepdim=True)
    qs = q.float() * scale
    p = torch.exp(qs @ k.float().transpose(-1, -2) - lse)
    dv = p.transpose(-1, -2) @ g32
    ds = p * (g32 @ v.float().transpose(-1, -2) - delta)
    dk = ds.transpose(-1, -2) @ qs
    dq = (ds @ k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bias_bwd_plain(q: Tensor, k: Tensor, v: Tensor, bias: Tensor, g: Tensor,
                                   scale: float | None = None
                                   ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The biased backward, the JAX package's XLA recompute
    (``_flash_attention_bwd``): logits from q·scale and k in their type,
    softmax in f32, dq, dk, dv and the (B·N, T, S) bias gradient in their
    operands' types."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = ((q * scale) @ k.transpose(-1, -2)).float() + bias.float()
    p = torch.softmax(logits, dim=-1)
    g32 = g.float()
    dp = g32 @ v.float().transpose(-1, -2)
    dlogits = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (dlogits @ k.float()) * scale
    dk = (dlogits.transpose(-1, -2) @ q.float()) * scale
    dv = p.transpose(-1, -2) @ g32
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dlogits.to(bias.dtype)


def _check_cuda_args(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None) -> None:
    BN, T, H = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError("flash_attention: q, k and v must share one type, float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    S = k.shape[1]
    if k.shape != v.shape or k.shape[0] != BN or k.shape[2] != H or T < 1 or S < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B·N, T, H), (B·N, S, H), (B·N, S, H)")
    if H % 16 or not 16 <= H <= MAX_HEAD_DIM or BN > MAX_PAIRS:
        raise ValueError(f"flash_attention: no CUDA kernel for head_dim={H}, {BN} (batch·head) "
                         f"pairs; it takes head widths 16..{MAX_HEAD_DIM} in steps of 16 and at "
                         f"most {MAX_PAIRS} pairs")
    if bias is not None and (bias.shape != (BN, T, S)
                             or bias.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"flash_attention: bias must be ({BN}, {T}, {S}) float32 or bfloat16, "
                         f"got {tuple(bias.shape)} {bias.dtype}")


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None = None, *,
                         with_lse: bool = True, scale: float | None = None
                         ) -> tuple[Tensor, Tensor | None]:
    """Launch ``csrc/flash_attention.cu`` on the current stream: (out, lse or
    None). Inference asks for no lse. ``scale`` defaults to H**-0.5 (a
    zero-padded head passes its true width's)."""
    _check_cuda_args(q, k, v, bias)
    BN, T, H = q.shape
    scale = H**-0.5 if scale is None else scale
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(BN, T, 1, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        err = _cuda.lib().vtt_flash_fwd(
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(bias),
            int(bias is not None and bias.dtype == torch.bfloat16), int(q.dtype == torch.bfloat16),
            _cuda.ptr(out), _cuda.ptr(lse), BN, T, k.shape[1], H, float(scale), _cuda.stream(),
        )
        _cuda.check(err, "flash_attention")
    _cuda.LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                             g: Tensor, scale: float | None = None
                             ) -> tuple[Tensor, Tensor, Tensor]:
    """Launch ``csrc/flash_attention_bwd.cu`` (delta, dK/dV, dQ) on the
    current stream."""
    _check_cuda_args(q, k, v, None)
    BN, T, H = q.shape
    scale = H**-0.5 if scale is None else scale
    if out.shape != q.shape or g.shape != q.shape or lse.shape != (BN, T, 1):
        raise ValueError("flash_attention backward: out and g must match q, lse be (B·N, T, 1)")
    if out.dtype != q.dtype or g.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash_attention backward: out and g in q's type, lse float32")
    q, k, v, out, g = (t.contiguous() for t in (q, k, v, out, g))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(BN, T, device=q.device)  # Σ g·out per query row, f32
    with torch.cuda.device(q.device):
        err = _cuda.lib().vtt_flash_bwd(
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(out), _cuda.ptr(g),
            _cuda.ptr(lse), _cuda.ptr(delta), int(q.dtype == torch.bfloat16),
            _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv), BN, T, k.shape[1], H,
            float(scale), _cuda.stream(),
        )
        _cuda.check(err, "flash_attention backward")
    _cuda.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention on (B·N, T, H) operands: the kernels on
    CUDA tensors, the plain versions on CPU tensors or with ``plain``. Saves
    q, k, v, the output and lse (and the bias, if any): nothing of size
    (T, S) but a bias given as such."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, plain):
        if plain or not q.is_cuda:
            out, lse = flash_attention_plain(q, k, v, bias, scale)
        else:
            out, lse = flash_attention_cuda(q, k, v, bias, scale=scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.plain = scale, plain
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        g = g.to(q.dtype)
        if bias is not None:
            dq, dk, dv, dbias = flash_attention_bias_bwd_plain(q, k, v, bias, g, ctx.scale)
            return dq, dk, dv, dbias, None, None
        bwd = flash_attention_bwd_plain if ctx.plain or not g.is_cuda else flash_attention_bwd_cuda
        return (*bwd(q, k, v, out, lse, g, ctx.scale), None, None, None)


@torch.library.custom_op("vtt::flash_attention", mutates_args=(), device_types="cpu")
def _flash_attention_op(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None,
                        scale: float | None = None) -> Tensor:
    return flash_attention_plain(q, k, v, bias, scale)[0]


@_flash_attention_op.register_kernel("cuda")
def _(q, k, v, bias, scale=None):
    return flash_attention_cuda(q, k, v, bias, with_lse=False, scale=scale)[0]


@_flash_attention_op.register_fake
def _(q, k, v, bias, scale=None):
    return torch.empty_like(q)


def padded_head(h: int, is_cuda: bool) -> int:
    """The head width the operands are relaid out to: on a CUDA tensor the
    next multiple of 16 (the kernels' width step; zero columns add nothing
    to q·kᵀ, and v's give output columns that are sliced away), else ``h``."""
    return -(-h // 16) * 16 if is_cuda else h


def flash_attention(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None = None, *,
                    plain: bool = False) -> Tensor:
    """Flash attention on (B, T, N, H) operands; ``bias`` broadcasts against
    (B, N, T, S). Returns (B, T, N, H) in q's type. Differentiable;
    ``plain`` runs the plain PyTorch versions on any device (for checking
    the kernels)."""
    B, T, N, H = q.shape
    S = k.shape[1]
    Hp = padded_head(H, q.is_cuda and not plain)

    def heads(t: Tensor, n: int) -> Tensor:  # the relayout copy, zero-padded to Hp
        t = t.transpose(1, 2)
        return (t if Hp == H else torch.nn.functional.pad(t, (0, Hp - H))).reshape(B * N, n, Hp)

    args = (heads(q, T), heads(k, S), heads(v, S),
            None if bias is None else bias.expand(B, N, T, S).reshape(B * N, T, S), H**-0.5)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args[:4]):
        out = FlashAttentionFunction.apply(*args, plain)
    elif plain:
        out = flash_attention_plain(*args)[0]
    else:
        out = _flash_attention_op(*args)
    return out.reshape(B, N, T, Hp)[..., :H].transpose(1, 2)
