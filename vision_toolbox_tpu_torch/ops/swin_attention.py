"""Swin window attention (K7 forward and backward) — port of
``vision_toolbox_tpu/ops/swin_attention.py``.

Per window and head, with q/k/v in the projections' packed (B, nW, T, N·hd)
layout, a learnable relative-position bias pe (1, N, T, T) and, on shifted
blocks, a constant shift mask (nW, T, T)::

    out = softmax((q·scale)·kᵀ + pe + mask)·v,      scale = hd**-0.5

``swin_window_attention`` is the entry point. Without gradients (serving,
``torch.export``) it runs the custom op ``vtt::swin_window_attention``: on
CPU tensors ``swin_attention_plain``, on CUDA tensors the hand-written kernel
in ``csrc/swin_attention.cu``. Under autograd it runs
``SwinAttentionFunction``, whose backward is the kernels in
``csrc/swin_attention_bwd.cu`` on CUDA tensors and ``swin_attention_bwd_plain``
on CPU tensors or with ``plain=True``. A CUDA tensor launches the kernels or
raises.

Rounding points are the TPU kernels' (``_fwd_kernel``, ``_bwd_kernel``):
q, k, v, pe, the mask and the cotangent are read in their types and widened
to f32; q·scale, the logits (pe and the mask added separately), the softmax
and every backward intermediate are f32; out, dq, dk and dv are rounded once
to the input type; dPE is the f32 sum of ds over batch and windows, returned
in pe's type; the mask's cotangent is zero. On the card, bf16 windows run
register-tile kernels (``mma.sync`` with the scores and the softmax in
registers, p and ds as two bf16 planes) wherever a window-head's q, k, v (and
g) tiles fit shared memory: every window up to 64 tokens and window 14 at
head 32, so every registered Swin; they form the logits as
(q·kᵀ)·scale and normalise the softmax after the product: the same values up
to f32 rounding. f32 operands, and the bf16 windows the tiles do not take,
run CUDA-core kernels in the TPU kernels' order; the library's launcher
chooses (``kernel_route``). A kernel block owns one head, one window index
and a run of images (``windows_per_block``, sized for the chosen kernels). The
JAX package's default dispatch runs its einsum path instead
(``use_swin_kernel`` is off, a v5e measurement), which rounds the logits and
the softmax in the input type.
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import _cuda

MAX_WINDOW_SEQ = 256  # ops/swin_attention.py MAX_WINDOW_SEQ; csrc/swin_attention.cuh MAX_SEQ
MAX_HEAD_DIM = 128  # csrc/swin_attention.cuh MAX_HEAD: four head columns a lane
# The kernels a call runs, as csrc/swin_attention.cuh `swin_route` chooses them:
# the CUDA-core kernels, or the register tiles for windows of one key tile or of
# more. Blocks in all that fill the card for each: eight 256-thread blocks on each
# of the H100's 132 SMs for the CUDA cores and for one key tile, two for more,
# whose blocks take up to 13 warps and hold a T × T dPE partial each
ROUTE_CORES, ROUTE_SMALL, ROUTE_LARGE = 0, 1, 2
_TARGET_BLOCKS = {ROUTE_CORES: 132 * 8, ROUTE_SMALL: 132 * 8, ROUTE_LARGE: 132 * 2}


def use_swin_kernel(t: int, s: int, head_dim: int) -> bool:
    """Shape rule of the CUDA kernels: square windows T = S ≤ 256 (window 7,
    T = 49, and window 14, T = 196, of the S3 variants) and head widths up to
    128 (every registered Swin has 32), any batch and window count."""
    return t == s and 1 <= t <= MAX_WINDOW_SEQ and 1 <= head_dim <= MAX_HEAD_DIM


def windows_per_block(batch: int, n_windows: int, n_heads: int, route: int) -> int:
    """Windows a kernel block takes in turn: one window index and one head,
    in a run of this many consecutive images, so that the head's pe and the
    window's mask serve the whole run. Runs are as short as filling the card
    asks (``_TARGET_BLOCKS`` blocks in all for the ``route``'s kernels), at
    least one image each."""
    runs = max(1, min(batch, -(-_TARGET_BLOCKS[route] // (n_windows * n_heads))))
    return -(-batch // runs)


def kernel_route(q: Tensor, pe: Tensor, mask: Tensor | None, n_heads: int, bwd: bool) -> int:
    """The kernels (``ROUTE_*``) the forward or the backward launches for
    these operands, as the library's launcher chooses them."""
    T, D = q.shape[-2:]
    return _cuda.lib().vtt_swin_attention_route(T, D // n_heads, _is_bf16(q), _is_bf16(pe),
                                                int(mask is not None), _is_bf16(mask), int(bwd))


def _heads(t: Tensor, n_heads: int) -> Tensor:
    """(B, nW, T, N·hd) → (B, nW, N, T, hd) f32."""
    B, nW, T, D = t.shape
    return t.float().reshape(B, nW, T, n_heads, D // n_heads).transpose(2, 3)


def _merge(t: Tensor, dtype: torch.dtype) -> Tensor:
    """(B, nW, N, T, hd) → (B, nW, T, N·hd) in ``dtype``."""
    B, nW, N, T, hd = t.shape
    return t.transpose(2, 3).reshape(B, nW, T, N * hd).to(dtype)


def _probs(q: Tensor, k: Tensor, pe: Tensor, mask: Tensor | None, n_heads: int):
    """p (B, nW, N, T, S) and q·scale (B, nW, N, T, hd), f32."""
    qs = _heads(q, n_heads) * (q.shape[-1] // n_heads) ** -0.5
    logits = qs @ _heads(k, n_heads).transpose(-1, -2) + pe.float()[None]
    if mask is not None:
        logits = logits + mask.float()[None, :, None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True), qs


def _fwd(q: Tensor, k: Tensor, v: Tensor, pe: Tensor, mask: Tensor | None, n_heads: int,
         operand) -> Tensor:
    """The forward's math, p passed through ``operand`` where it enters p·v."""
    p, _ = _probs(q, k, pe, mask, n_heads)
    return _merge(operand(p) @ _heads(v, n_heads), q.dtype)


def swin_attention_plain(q: Tensor, k: Tensor, v: Tensor, pe: Tensor, mask: Tensor | None,
                         n_heads: int) -> Tensor:
    """Plain PyTorch version of the forward kernel, same rounding points."""
    return _fwd(q, k, v, pe, mask, n_heads, lambda x: x)


def swin_attention_one_plane(q: Tensor, k: Tensor, v: Tensor, pe: Tensor, mask: Tensor | None,
                             n_heads: int) -> Tensor:
    """The forward's second-plane control: ``swin_attention_plain`` with p
    rounded to bf16 once before p·v, as a kernel that fed it to the tensor
    cores as one bf16 plane would compute. The checks use it to show that
    their bounds tell such a kernel from K7; the port never calls it."""
    return _fwd(q, k, v, pe, mask, n_heads, lambda x: x.bfloat16().float())


def _bwd(q: Tensor, k: Tensor, v: Tensor, pe: Tensor, mask: Tensor | None, n_heads: int,
         g: Tensor, operand) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The backward's math, p and ds passed through ``operand`` where they
    enter dv = pᵀ·g, dq = ds·k and dk = dsᵀ·(q·scale); dPE sums ds itself."""
    p, qs = _probs(q, k, pe, mask, n_heads)
    go, kh = _heads(g, n_heads), _heads(k, n_heads)
    dv = operand(p).transpose(-1, -2) @ go
    dp = go @ _heads(v, n_heads).transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (operand(ds) @ kh) * (q.shape[-1] // n_heads) ** -0.5
    dk = operand(ds).transpose(-1, -2) @ qs
    return (_merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype),
            ds.sum((0, 1))[None])


def swin_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, pe: Tensor, mask: Tensor | None,
                             n_heads: int, g: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the backward kernels, same rounding points:
    (dq, dk, dv in their operands' types, dPE (1, N, T, S) f32)."""
    return _bwd(q, k, v, pe, mask, n_heads, g, lambda x: x)


def swin_attention_bwd_one_plane(q: Tensor, k: Tensor, v: Tensor, pe: Tensor,
                                 mask: Tensor | None, n_heads: int, g: Tensor
                                 ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The backward's second-plane control: ``swin_attention_bwd_plain`` with
    p rounded to bf16 once before dv and ds before dq and dk
    (``swin_attention_one_plane`` is the forward's); the port never calls it."""
    return _bwd(q, k, v, pe, mask, n_heads, g, lambda x: x.bfloat16().float())


def _check_cuda_args(q: Tensor, k: Tensor, v: Tensor, pe: Tensor, mask: Tensor | None,
                     n_heads: int) -> tuple[int, int, int, int]:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"swin_window_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be one (B, nW, T, N·hd) shape")
    B, nW, T, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError("swin_window_attention: q, k and v must share one type, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D % n_heads or not use_swin_kernel(T, T, D // n_heads) or B > 2**31 // max(nW, 1):
        raise ValueError(f"swin_window_attention: no CUDA kernel for T={T}, {n_heads} heads of "
                         f"{D / n_heads:g}; gate calls with use_swin_kernel()")
    for name, t, shape in (("pe", pe, (1, n_heads, T, T)), ("mask", mask, (nW, T, T))):
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError(f"swin_window_attention: {name} must be {shape} float32 or "
                             f"bfloat16, got {tuple(t.shape)} {t.dtype}")
    return B, nW, T, D


def _is_bf16(t: Tensor | None) -> int:
    return int(t is not None and t.dtype == torch.bfloat16)


def swin_attention_cuda(q: Tensor, k: Tensor, v: Tensor, pe: Tensor, mask: Tensor | None,
                        n_heads: int) -> Tensor:
    """Launch ``csrc/swin_attention.cu`` on the current stream."""
    B, nW, T, D = _check_cuda_args(q, k, v, pe, mask, n_heads)
    q, k, v, pe = q.contiguous(), k.contiguous(), v.contiguous(), pe.contiguous()
    mask = None if mask is None else mask.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _cuda.lib().vtt_swin_attention_fwd(
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(pe), _is_bf16(pe),
            _cuda.ptr(mask), _is_bf16(mask), _is_bf16(q), _cuda.ptr(out), B, nW, T, n_heads,
            D // n_heads, windows_per_block(B, nW, n_heads, kernel_route(q, pe, mask, n_heads,
                                                                         False)),
            float((D // n_heads) ** -0.5),
            _cuda.stream(),
        )
        _cuda.check(err, "swin_window_attention")
    _cuda.LAUNCHES["swin_attention"] += 1
    return out


def swin_attention_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, pe: Tensor, mask: Tensor | None,
                            n_heads: int, g: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Launch ``csrc/swin_attention_bwd.cu`` (the gradients, then the
    fixed-order dPE sum) on the current stream."""
    B, nW, T, D = _check_cuda_args(q, k, v, pe, mask, n_heads)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError("swin_window_attention backward: g must match q in shape and type")
    q, k, v, pe, g = (t.contiguous() for t in (q, k, v, pe, g))
    mask = None if mask is None else mask.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    per_block = windows_per_block(B, nW, n_heads, kernel_route(q, pe, mask, n_heads, True))
    blocks = nW * -(-B // per_block)  # of each head
    partials = torch.empty(blocks, n_heads, T, T, device=q.device)  # each block's dPE sum
    dpe = torch.empty(1, n_heads, T, T, device=q.device)
    with torch.cuda.device(q.device):
        err = _cuda.lib().vtt_swin_attention_bwd(
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(g), _cuda.ptr(pe), _is_bf16(pe),
            _cuda.ptr(mask), _is_bf16(mask), _is_bf16(q), _cuda.ptr(dq), _cuda.ptr(dk),
            _cuda.ptr(dv), _cuda.ptr(partials), _cuda.ptr(dpe), B, nW, T, n_heads, D // n_heads,
            per_block, float((D // n_heads) ** -0.5), _cuda.stream(),
        )
        _cuda.check(err, "swin_window_attention backward")
    _cuda.LAUNCHES["swin_attention_bwd"] += 1
    return dq, dk, dv, dpe


class SwinAttentionFunction(torch.autograd.Function):
    """Differentiable window attention: the kernels on CUDA tensors, the
    plain versions on CPU tensors or with ``plain``. Gradients for q, k, v
    and pe (in its type); the mask is a constant."""

    @staticmethod
    def forward(ctx, q, k, v, pe, mask, n_heads, plain):
        fwd = swin_attention_plain if plain or not q.is_cuda else swin_attention_cuda
        ctx.save_for_backward(q, k, v, pe, mask)
        ctx.n_heads, ctx.plain = n_heads, plain
        return fwd(q, k, v, pe, mask, n_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, pe, mask = ctx.saved_tensors
        bwd = swin_attention_bwd_plain if ctx.plain or not g.is_cuda else swin_attention_bwd_cuda
        dq, dk, dv, dpe = bwd(q, k, v, pe, mask, ctx.n_heads, g.to(q.dtype))
        return dq, dk, dv, dpe.to(pe.dtype), None, None, None


@torch.library.custom_op("vtt::swin_window_attention", mutates_args=(), device_types="cpu")
def _swin_attention_op(q: Tensor, k: Tensor, v: Tensor, pe: Tensor, mask: Tensor | None,
                       n_heads: int) -> Tensor:
    return swin_attention_plain(q, k, v, pe, mask, n_heads)


_swin_attention_op.register_kernel("cuda")(swin_attention_cuda)


@_swin_attention_op.register_fake
def _(q, k, v, pe, mask, n_heads):
    return torch.empty_like(q)


def swin_window_attention(q: Tensor, k: Tensor, v: Tensor, pe: Tensor, mask: Tensor | None,
                          n_heads: int, *, plain: bool = False) -> Tensor:
    """Biased window attention; q/k/v (B, nW, T, N·hd), pe (1, N, T, T),
    mask (nW, T, T) or None. Returns (B, nW, T, N·hd) in q's type.
    Differentiable in q, k, v and pe; ``plain`` runs the plain PyTorch
    versions on any device (for checking the kernels)."""
    args = (q, k, v, pe, mask)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return SwinAttentionFunction.apply(*args, n_heads, plain)
    if plain:
        return swin_attention_plain(*args, n_heads)
    return _swin_attention_op(*args, n_heads)
