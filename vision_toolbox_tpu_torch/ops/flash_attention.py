"""Flash attention (K6 forward and backward) — port of
``vision_toolbox_tpu/ops/flash_attention.py``.

softmax(q·kᵀ·scale + bias)·v for long sequences, scale = head_dim**-0.5,
with O(T) memory: the forward saves only the output and the per-row
logsumexp ``lse``; the backward recomputes p = exp(q·kᵀ·scale − lse) tile by
tile (FlashAttention-2: dK/dV per key tile, dQ per query tile), so no
(T, S) tensor goes to device memory in training or inference.

``flash_attention`` is the entry point, on the (B, T, N, H) layout (the bias,
which broadcasts against (B, N, T, S), goes in as (B·N, T, S)). On CUDA
tensors the kernels (``csrc/flash_attention{,_bwd}.cu``, register-tile
mma.sync products from ``csrc/attention_mma.cuh``) read q, k, v and the
cotangent in place with their strides and write the output and dq, dk, dv
in place in (B, T, N, H): no relayout, pad or output copy. A head that is
no multiple of 16 is zero-padded in the kernels' shared memory; heads up to
256 run, above 128 one ≤ 128-wide chunk of output columns at a time.
Without gradients (serving, ``torch.export``) it runs the custom op
``vtt::flash_attention`` on the same layout: on CPU tensors
``flash_attention_plain`` after a relayout inside the op, on CUDA tensors
the kernel. Under autograd it runs ``FlashAttentionFunction``, whose
unbiased backward is the kernels on CUDA tensors and
``flash_attention_bwd_plain`` on CPU tensors or with ``plain=True``. A CUDA
tensor launches the kernels or raises. The biased backward, whose bias
gradient is (T, S)-sized anyway, is the JAX package's XLA recompute on every
device (``flash_attention_bias_bwd_plain``). The plain versions work on the
flat (B·N, T, H) layout, which the CUDA wrappers also take (as N = 1).

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
MAX_HEAD_DIM = 256  # csrc/flash_attention{,_bwd}.cu MAX_HEAD_DIM: the widest head whose tiles fit
MAX_PAIRS = 65535  # (batch·head) pairs: the kernels' grid y extent


def use_flash_attention(t: int) -> bool:
    """The JAX package's dispatch rule (``use_pallas``; its caller sends
    attention dropout elsewhere): T ≥ 1024 and a multiple of 128, for any
    head width. siglip vit_b_16 at 512 px (T = 1024) passes; T = 1025 (a cls
    token), 577 (384 px) and the MAP probe (T = 1) do not. On a CUDA tensor
    the kernels zero-pad the head to a multiple of 16 in shared memory (72
    runs as 80) and take heads up to 256 (above 128 in column chunks); a
    wider head raises in ``flash_attention_cuda``."""
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


def _flat(t: Tensor) -> Tensor:
    """(B, L, N, H) → the plain versions' (B·N, L, H); a flat tensor as it is."""
    if t.ndim == 3:
        return t
    B, L, N, H = t.shape
    return t.transpose(1, 2).reshape(B * N, L, H)


def _unflat(t: Tensor, like: Tensor) -> Tensor:
    """(B·N, L, H) → ``like``'s (B, L, N, H) layout (a view)."""
    if like.ndim == 3:
        return t
    B, L, N, H = like.shape
    return t.reshape(B, N, L, H).transpose(1, 2)


def _check_cuda_args(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None
                     ) -> tuple[int, int, int, int, int]:
    """What the kernels take: q (B, T, N, H) and k, v (B, S, N, H), or the
    flat (B·N, T, H) and (B·N, S, H); one type, f32 or bf16; heads up to
    MAX_HEAD_DIM with a unit last stride (the other strides are free); at
    most MAX_PAIRS pairs; a (B·N, T, S) bias. Returns (B, N, T, S, H)."""
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError("flash_attention: q, k and v must share one type, float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    packed = q.ndim == 4
    if q.ndim not in (3, 4) or k.ndim != q.ndim or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:] or q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, T, N, H), (B, S, N, H), (B, S, N, H) "
                         "or (B·N, T, H), (B·N, S, H), (B·N, S, H)")
    B, T, H = q.shape[0], q.shape[1], q.shape[-1]
    N, S = q.shape[2] if packed else 1, k.shape[1]
    if not 1 <= H <= MAX_HEAD_DIM or B * N > MAX_PAIRS:
        raise ValueError(f"flash_attention: no CUDA kernel for head_dim={H}, {B * N} (batch·head) "
                         f"pairs; it takes head widths up to {MAX_HEAD_DIM} and at most "
                         f"{MAX_PAIRS} pairs")
    if H > 1 and any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v need a unit stride along the head "
                         f"dimension; got strides {q.stride()}, {k.stride()}, {v.stride()}")
    if bias is not None and (bias.shape != (B * N, T, S)
                             or bias.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"flash_attention: bias must be ({B * N}, {T}, {S}) float32 or "
                         f"bfloat16, got {tuple(bias.shape)} {bias.dtype}")
    return B, N, T, S, H


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None = None, *,
                         with_lse: bool = True, scale: float | None = None
                         ) -> tuple[Tensor, Tensor | None]:
    """Launch ``csrc/flash_attention.cu`` on the current stream on (B, T, N, H)
    or flat (B·N, T, H) operands, read in place: (out in q's layout,
    contiguous; lse (B·N, T, 1) f32 or None). Inference asks for no lse.
    ``scale`` defaults to H**-0.5."""
    B, N, T, S, H = _check_cuda_args(q, k, v, bias)
    scale = H**-0.5 if scale is None else scale
    bias = None if bias is None else bias.contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(B * N, T, 1, device=q.device) if with_lse else None
    strides = _cuda.strides(q, k, v, out)
    with torch.cuda.device(q.device):
        err = _cuda.lib().vtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _cuda.ptr(bias),
            int(bias is not None and bias.dtype == torch.bfloat16), int(q.dtype == torch.bfloat16),
            _cuda.ptr(out), _cuda.ptr(lse), strides, B, N, T, S, H, float(scale), _cuda.stream(),
        )
        _cuda.check(err, "flash_attention")
    _cuda.LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                             g: Tensor, scale: float | None = None
                             ) -> tuple[Tensor, Tensor, Tensor]:
    """Launch ``csrc/flash_attention_bwd.cu`` (delta, dK/dV, dQ) on the
    current stream on (B, T, N, H) or flat operands, read in place; dq, dk
    and dv come back contiguous in q's, k's and v's layouts."""
    B, N, T, S, H = _check_cuda_args(q, k, v, None)
    scale = H**-0.5 if scale is None else scale
    if out.shape != q.shape or g.shape != q.shape or lse.shape != (B * N, T, 1):
        raise ValueError("flash_attention backward: out and g must match q, lse be (B·N, T, 1)")
    if out.dtype != q.dtype or g.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash_attention backward: out and g in q's type, lse float32")
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    delta = torch.empty(B * N, T, device=q.device)  # Σ g·out per query row, f32
    strides = _cuda.strides(q, k, v, out, g, dq, dk, dv)
    with torch.cuda.device(q.device):
        err = _cuda.lib().vtt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            _cuda.ptr(lse), _cuda.ptr(delta), int(q.dtype == torch.bfloat16),
            _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv), strides, B, N, T, S, H, float(scale),
            _cuda.stream(),
        )
        _cuda.check(err, "flash_attention backward")
    _cuda.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention on (B, T, N, H) operands: the kernels
    on CUDA tensors, in place, the plain versions on CPU tensors or with
    ``plain``. Saves q, k, v, the output and lse (B·N, T, 1) in the caller's
    layout (and the bias, if any): nothing of size (T, S) but a bias given
    as such."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, plain):
        if plain or not q.is_cuda:
            out, lse = flash_attention_plain(_flat(q), _flat(k), _flat(v), bias, scale)
            out = _unflat(out, q)
        else:
            out, lse = flash_attention_cuda(q, k, v, bias, scale=scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.plain = scale, plain
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        g = g.to(q.dtype)
        if bias is None and not ctx.plain and g.is_cuda:
            if g.shape[-1] > 1 and g.stride(-1) != 1:  # e.g. the expanded cotangent of a sum
                g = g.contiguous()
            return (*flash_attention_bwd_cuda(q, k, v, out, lse, g, ctx.scale), None, None, None)
        flat = [_flat(t) for t in (q, k, v)]
        if bias is not None:
            *grads, dbias = flash_attention_bias_bwd_plain(*flat, bias, _flat(g), ctx.scale)
        else:
            grads, dbias = flash_attention_bwd_plain(*flat, _flat(out), lse, _flat(g),
                                                     ctx.scale), None
        return (*(_unflat(d, t) for d, t in zip(grads, (q, k, v))), dbias, None, None)


@torch.library.custom_op("vtt::flash_attention", mutates_args=(), device_types="cpu")
def _flash_attention_op(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None,
                        scale: float | None = None) -> Tensor:
    """On (B, T, N, H) (or flat) operands; on CPU the plain version after a
    relayout to (B·N, T, H) here, inside the op."""
    out = flash_attention_plain(_flat(q), _flat(k), _flat(v), bias, scale)[0]
    return _unflat(out, q).contiguous()


@_flash_attention_op.register_kernel("cuda")
def _(q, k, v, bias, scale=None):
    return flash_attention_cuda(q, k, v, bias, with_lse=False, scale=scale)[0]


@_flash_attention_op.register_fake
def _(q, k, v, bias, scale=None):
    return q.new_empty(q.shape)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None = None, *,
                    plain: bool = False) -> Tensor:
    """Flash attention on (B, T, N, H) operands; ``bias`` broadcasts against
    (B, N, T, S). Returns (B, T, N, H) in q's type. Differentiable;
    ``plain`` runs the plain PyTorch versions on any device (for checking
    the kernels). On CUDA tensors nothing is copied around the kernels."""
    B, T, N, H = q.shape
    S = k.shape[1]
    if bias is not None:
        bias = bias.expand(B, N, T, S).reshape(B * N, T, S)
    scale = H**-0.5
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, bias)):
        return FlashAttentionFunction.apply(q, k, v, bias, scale, plain)
    if plain:
        return _unflat(flash_attention_plain(_flat(q), _flat(k), _flat(v), bias, scale)[0], q)
    return _flash_attention_op(q, k, v, bias, scale)
