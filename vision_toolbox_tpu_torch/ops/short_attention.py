"""Short-sequence attention (K2 forward and backward) — port of
``vision_toolbox_tpu/ops/short_attention.py``.

softmax(q·kᵀ·scale)·v, scale = head_dim**-0.5, no bias, for the shapes
vision transformers give it: 2 ≤ T, S ≤ 512, heads up to 128 wide, and at
least 64 (batch·head) pairs (vit_b_16 at batch 8: T = S = 197, 96 pairs).
The whole logit row of a query is softmaxed at once (no running softmax);
logits, p and p·v are f32 and the output is rounded once. The backward saves
only q, k and v and recomputes p.

Rounding points are the TPU kernels' (``_packed_fwd_kernel``,
``_packed_bwd_kernel``): q widened to f32 and multiplied by the scale, f32
logits and softmax, p kept in f32 for p·v (``jax.nn.dot_product_attention``
instead rounds p to v's type), one rounding to the input type; the backward
forms dv = pᵀ·g, ds = p∘(g·vᵀ − Σ(g·vᵀ∘p)), dq = ds·k·scale and
dk = dsᵀ·(q·scale) in f32 and rounds each once.

``short_attention_packed`` and ``short_attention`` are the entry points, on
(B, T, N, H). The JAX package's two entries run one function on two
layouts, the packed (B, T, N·H) one and, when the packed backward overflows
the TPU's VMEM (ViT-H-class widths), the flat (B·N, T, H) one; here both
run the same kernels, which read the packed layout in place
(``csrc/short_attention.cu``, ``csrc/short_attention_bwd.cu``). Not ported,
as they tile work for the TPU's grid and VMEM: ``group``, ``interpret``,
``_pick_group``, ``_admit_group`` and ``_bwd_vmem_bytes``; the CUDA
kernels size their own tiles.

Without gradients (serving, ``torch.export``) the entries run the custom op
``vtt::short_attention``, which takes the pair test at run time, so an
exported program keeps its batch dimension free: at ≥ 64 pairs it runs K2
(the kernel on CUDA tensors, ``short_attention_plain`` on CPU tensors),
below that the JAX package's own dispatch target, ``dense_attention``
(``jax.nn.dot_product_attention``'s rounding). Under autograd they run
``ShortAttentionFunction``, whose backward is the kernels on CUDA tensors
and ``short_attention_bwd_plain`` on CPU tensors or with ``plain=True``. A
CUDA tensor inside the rule launches the kernels or raises.
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import _cuda

MAX_SHORT_SEQ = 512
MIN_PAIRS = 64  # (batch·head) pairs: below this the JAX package keeps XLA's attention
MAX_HEAD_DIM = 128


def short_shape(t: int, s: int, h: int) -> bool:
    """The shape terms of ``use_short``: what a traced program knows."""
    return 2 <= t <= MAX_SHORT_SEQ and 2 <= s <= MAX_SHORT_SEQ and h <= MAX_HEAD_DIM


def use_short(t: int, s: int, h: int, n_pairs: int) -> bool:
    """The JAX package's dispatch rule (``use_short``) without its backend
    test: the port's gate on every device, as ``use_flash_attention`` is for
    K6. Its caller sends biased attention and attention dropout elsewhere."""
    return short_shape(t, s, h) and n_pairs >= MIN_PAIRS


def dense_attention(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None = None) -> Tensor:
    """softmax(q·kᵀ·scale + bias)·v on (B, T, N, H) with
    ``jax.nn.dot_product_attention``'s rounding points (jax 0.9.0
    ``_dot_product_attention_core``): the logits from the input-type
    operands accumulated in f32, scaled and biased in f32, the softmax in
    f32, then p rounded to v's type before p·v (accumulated in f32, rounded
    once to q's type). The JAX package runs it for attention that neither
    K2's nor K6's rule admits."""
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs.float(), v.float()).to(q.dtype)


def _probs(q: Tensor, k: Tensor) -> tuple[Tensor, Tensor]:
    """(q·scale in f32, p (B, N, T, S) f32): K2's logits and whole-row softmax."""
    qs = q.float() * q.shape[-1] ** -0.5
    logits = torch.einsum("btnh,bsnh->bnts", qs, k.float())
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return qs, e / e.sum(-1, keepdim=True)


def short_attention_plain(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Plain PyTorch version of the forward kernel on (B, T, N, H) q and
    (B, S, N, H) k, v: out in q's type."""
    _, p = _probs(q, k)
    return torch.einsum("bnts,bsnh->btnh", p, v.float()).to(q.dtype)


def _bwd(q: Tensor, k: Tensor, v: Tensor, g: Tensor, operand
         ) -> tuple[Tensor, Tensor, Tensor]:
    """The backward's math, p and ds passed through ``operand`` where they
    enter their products."""
    qs, p = _probs(q, k)
    g32, k32 = g.float(), k.float()
    dv = torch.einsum("bnts,btnh->bsnh", operand(p), g32)
    dp = torch.einsum("btnh,bsnh->bnts", g32, v.float())
    ds = operand(p * (dp - (dp * p).sum(-1, keepdim=True)))
    dq = torch.einsum("bnts,bsnh->btnh", ds, k32) * q.shape[-1] ** -0.5
    dk = torch.einsum("bnts,btnh->bsnh", ds, qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def short_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, g: Tensor
                              ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the backward kernels: p recomputed from q, k,
    every intermediate f32, dq, dk, dv rounded once to their operands'
    types."""
    return _bwd(q, k, v, g, lambda x: x)


def short_attention_bwd_one_plane(q: Tensor, k: Tensor, v: Tensor, g: Tensor
                                  ) -> tuple[Tensor, Tensor, Tensor]:
    """The backward's second-plane control: ``short_attention_bwd_plain``
    with p rounded to bf16 once before dv = pᵀ·g and ds rounded to bf16 once
    before dq = ds·k and dk = dsᵀ·q, as a kernel that fed them to the tensor
    cores as one bf16 plane would compute (``dense_attention`` is the
    forward's). The checks use it to show that their bounds tell such a
    kernel from K2; the port never calls it."""
    return _bwd(q, k, v, g, lambda x: x.bfloat16().float())


def _check_cuda_args(q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError("short_attention: q, k and v must share one type, float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"short_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, T, N, H), (B, S, N, H), (B, S, N, H)")
    B, T, N, H = q.shape
    S = k.shape[1]
    if not (1 <= T <= MAX_SHORT_SEQ and 1 <= S <= MAX_SHORT_SEQ and 1 <= H <= MAX_HEAD_DIM):
        raise ValueError(f"short_attention: no CUDA kernel for T={T}, S={S}, head_dim={H}; it "
                         f"takes T, S ≤ {MAX_SHORT_SEQ} and heads ≤ {MAX_HEAD_DIM}")


def short_attention_cuda(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Launch ``csrc/short_attention.cu`` on the current stream."""
    _check_cuda_args(q, k, v)
    B, T, N, H = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _cuda.lib().vtt_short_attention_fwd(
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), int(q.dtype == torch.bfloat16),
            _cuda.ptr(out), B, N, T, k.shape[1], H, float(H**-0.5), _cuda.stream(),
        )
        _cuda.check(err, "short_attention")
    _cuda.LAUNCHES["short_attention"] += 1
    return out


def short_attention_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, g: Tensor
                             ) -> tuple[Tensor, Tensor, Tensor]:
    """Launch ``csrc/short_attention_bwd.cu`` (rows: dq with each row's
    statistics; keys: dK/dV) on the current stream."""
    _check_cuda_args(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"short_attention backward: g {tuple(g.shape)} {g.dtype} must match q")
    B, T, N, H = q.shape
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse, delta = (torch.empty(B * N * T, device=q.device) for _ in range(2))  # per row, f32
    with torch.cuda.device(q.device):
        err = _cuda.lib().vtt_short_attention_bwd(
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(g), int(q.dtype == torch.bfloat16),
            _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv), _cuda.ptr(lse), _cuda.ptr(delta),
            B, N, T, k.shape[1], H, float(H**-0.5), _cuda.stream(),
        )
        _cuda.check(err, "short_attention backward")
    _cuda.LAUNCHES["short_attention_bwd"] += 1
    return dq, dk, dv


class ShortAttentionFunction(torch.autograd.Function):
    """Differentiable K2 on (B, T, N, H) operands: the kernels on CUDA
    tensors, the plain versions on CPU tensors or with ``plain``. Saves q, k
    and v only, as the JAX VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, plain):
        fwd = short_attention_plain if plain or not q.is_cuda else short_attention_cuda
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        return fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.to(q.dtype)
        bwd = short_attention_bwd_plain if ctx.plain or not g.is_cuda else short_attention_bwd_cuda
        return (*bwd(q, k, v, g), None)


def _dispatch(q: Tensor, k: Tensor, v: Tensor, k2) -> Tensor:
    """K2 (``k2``) at ≥ MIN_PAIRS pairs, else the JAX package's XLA path;
    contiguous, as the op's fake promises."""
    B, T, N, H = q.shape
    out = k2(q, k, v) if use_short(T, k.shape[1], H, B * N) else dense_attention(q, k, v)
    return out.contiguous()


@torch.library.custom_op("vtt::short_attention", mutates_args=(), device_types="cpu")
def _short_attention_op(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    return _dispatch(q, k, v, short_attention_plain)


@_short_attention_op.register_kernel("cuda")
def _(q, k, v):
    return _dispatch(q, k, v, short_attention_cuda)


@_short_attention_op.register_fake
def _(q, k, v):
    return torch.empty_like(q)


def short_attention_packed(q: Tensor, k: Tensor, v: Tensor, *, plain: bool = False) -> Tensor:
    """K2 on (B, T, N, H) operands inside ``short_shape``: at ≥ MIN_PAIRS
    (batch·head) pairs the kernels, else ``dense_attention``. Returns
    (B, T, N, H) in q's type. Differentiable; ``plain`` runs the plain
    PyTorch versions on any device (for checking the kernels)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        B, T, N, H = q.shape
        if not use_short(T, k.shape[1], H, B * N):
            return dense_attention(q, k, v)
        return ShortAttentionFunction.apply(q, k, v, plain)
    if plain:
        return _dispatch(q, k, v, short_attention_plain)
    return _short_attention_op(q, k, v)


def short_attention(q: Tensor, k: Tensor, v: Tensor, *, plain: bool = False) -> Tensor:
    """The JAX package's flat-layout entry: the same function as
    ``short_attention_packed`` and, here, the same kernels on the same
    (B, T, N, H) memory."""
    return short_attention_packed(q, k, v, plain=plain)
