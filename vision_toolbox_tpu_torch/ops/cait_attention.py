"""CaiT talking-head attention (K5 forward and backward) — port of
``vision_toolbox_tpu/ops/cait_attention.py``.

Per image, with q/k/v in the projections' packed (B, T, N·H) layout and
f32 (N, N) head mixes with (N,) biases::

    raw_h = (q_h·scale)·k_hᵀ          p_g  = softmax_s(mlb_g + Σ_h ml[g, h]·raw_h)
    o_g   = pw_g·v_g                  pw_g = mwb_g + Σ_h mw[g, h]·p_h

``talking_head_attention`` is the entry point. Without gradients (serving,
``torch.export``) it runs the custom op ``vtt::talking_head_attention``: on
CPU tensors ``talking_head_plain``, on CUDA tensors the hand-written kernel
in ``csrc/talking_head.cu``. Under autograd it runs ``TalkingHeadFunction``,
whose backward is the kernel in ``csrc/talking_head_bwd.cu`` on CUDA tensors
and ``talking_head_bwd_plain`` on CPU tensors or with ``plain=True``. A CUDA
tensor launches the kernels or raises.

Rounding points are the TPU kernels' (``_fwd_kernel``, ``_bwd_kernel``):
q, k, v and dout are read in their type and widened to f32; q·scale, the
raw logits, both mixes, the softmax and every backward intermediate are
f32; the output, dq, dk and dv are rounded once to the input type; the four
mix-parameter gradients are f32 sums over the batch. That is the kernel's
rounding on every device, not the JAX package's XLA branch, which rounds
the logits of a bf16 model to bf16 (``models/cait.py:58-70``).

The kernels take any head width: on CUDA tensors the wrappers zero-pad each
head to a multiple of 16 (zero columns add nothing to q·kᵀ and give zero
output columns, which are dropped) and pass the true width's scale. They
run their products on the tensor cores and keep every (B, H, T, S)
intermediate on the chip (``csrc/talking_head.cuh``); the logits are
(q·kᵀ)·scale, dk is (drawᵀ·q)·scale, and the softmax's Σe is taken under a
running max over key tiles: each an f32 rounding apart from the TPU
kernel's order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from . import _cuda

MAX_SEQ = 512
MAX_HEADS = 16
HEAD_STEP = 16  # csrc/talking_head.cuh: head widths run padded to a multiple of 16
# the rule's shape term (``_shape_term_bytes``) counts the logit chunks of
# the kernels' first design: 64, 48 or 16 columns, the widest dividing the head
CHUNKS = (64, 48, 16)
SMEM_LIMIT = 227 * 1024


def padded_head(hd: int) -> int:
    """The head width the kernels run: ``hd`` rounded up to a multiple of 16."""
    return -(-hd // HEAD_STEP) * HEAD_STEP


def _head_chunk(hd: int) -> int:
    """The first design's logit-chunk width for a head of ``hd``."""
    return next(c for c in CHUNKS if padded_head(hd) % c == 0)


def _shape_term_bytes(s: int, n_heads: int, head_dim: int) -> int:
    """The rule's shape term: the shared memory the kernels' first design
    gave a backward block of four query rows (three (H, 4, S padded to 4)
    f32 planes, four rows of a head chunk and the mix parameters). The
    tensor-core kernels need no score rows on chip; the term keeps the
    admitted set as it was, so every shape it admits still runs."""
    sp = -(-s // 4) * 4
    return (3 * n_heads * 4 * sp + 4 * n_heads * _head_chunk(head_dim)
            + 2 * n_heads * n_heads + 2 * n_heads) * 4


def tpu_rule_admits(t: int, s: int, n_heads: int) -> bool:
    """The JAX package's K5 rule without its TPU check
    (``vision_toolbox_tpu/ops/cait_attention.py`` ``use_talking_head_kernel``):
    T, S ≤ 512, at most 16 heads, and six (H, T, S) f32 planes within 12 MiB
    of VMEM. Any head width."""
    return (t <= MAX_SEQ and s <= MAX_SEQ and n_heads <= MAX_HEADS
            and 6 * n_heads * t * s * 4 <= 12 * 2**20)


def use_talking_head_kernel(t: int, s: int, n_heads: int, head_dim: int) -> bool:
    """Shape rule of the CUDA kernels: every shape of the JAX package's K5
    rule (``tpu_rule_admits``), any head width, and besides it the shapes
    whose shape term (``_shape_term_bytes``) is within one block's shared
    memory: cait_m_* at 224 px (16 heads at T = 196, 161 KB), beyond the
    TPU's VMEM budget. The kernels run every shape it admits."""
    return (
        1 <= t <= MAX_SEQ and 1 <= s <= MAX_SEQ and 1 <= n_heads <= MAX_HEADS
        and head_dim >= 1 and (tpu_rule_admits(t, s, n_heads)
                               or _shape_term_bytes(s, n_heads, head_dim) <= SMEM_LIMIT)
    )


def kernel_geometry(b: int, t: int, s: int, n_heads: int, head_dim: int, dtype: torch.dtype,
                    launch: str) -> dict[str, int]:
    """How the library lays out one launch over ``b`` images (``launch``:
    "fwd", "bwd_rows" or "bwd_keys"): 16-row tiles a block, blocks an
    image, ring stages, shared-memory bytes and threads a block (and, for
    the forward, the head chunks). Asks the CUDA library, so needs it built
    and the card it runs on."""
    hdp, bf = padded_head(head_dim), int(dtype == torch.bfloat16)
    lib = _cuda.lib()
    if launch == "fwd":
        out = (ctypes.c_longlong * 6)()
        err = lib.vtt_talking_head_fwd_geometry(b, t, n_heads, hdp, bf, out)
        keys = ("tiles_per_block", "blocks_per_image", "stages", "smem", "head_chunks", "threads")
    else:
        out = (ctypes.c_longlong * 5)()
        err = lib.vtt_talking_head_bwd_geometry(b, t, s, n_heads, hdp, bf,
                                                ("bwd_rows", "bwd_keys").index(launch), out)
        keys = ("tiles_per_block", "blocks_per_image", "stages", "smem", "threads")
    _cuda.check(err, "talking_head kernel_geometry")
    return dict(zip(keys, out))


class MixGrads(NamedTuple):
    """Gradients of the pre-softmax mix (ml, mlb) and the post-softmax mix
    (mw, mwb), f32."""

    ml: Tensor
    mlb: Tensor
    mw: Tensor
    mwb: Tensor


def _heads(t: Tensor, n_heads: int) -> Tensor:
    """(B, T, N·H) → (B, N, T, H) f32."""
    B, T, D = t.shape
    return t.float().reshape(B, T, n_heads, D // n_heads).transpose(1, 2)


def _merge(t: Tensor, dtype: torch.dtype) -> Tensor:
    """(B, N, T, H) → (B, T, N·H) in ``dtype``."""
    B, N, T, H = t.shape
    return t.transpose(1, 2).reshape(B, T, N * H).to(dtype)


def _mix(w: Tensor, x: Tensor, b: Tensor | None = None) -> Tensor:
    """Σ_h w[g, h]·x[:, h] (+ b[g]) over the heads axis of (B, N, T, S)."""
    out = torch.einsum("gh,bhts->bgts", w.float(), x)
    return out if b is None else out + b.float()[:, None, None]


def _forward_plain(q, k, v, ml, mlb, mw, mwb):
    """The forward's raw logits, probabilities, mixed probabilities (N
    heads, (B, N, T, S)) and q·scale, f32."""
    n = ml.shape[0]
    qs = _heads(q, n) * (q.shape[-1] // n) ** -0.5
    raw = qs @ _heads(k, n).transpose(-1, -2)
    p = torch.softmax(_mix(ml, raw, mlb), dim=-1)
    return raw, p, _mix(mw, p, mwb), qs


def talking_head_plain(q: Tensor, k: Tensor, v: Tensor, ml: Tensor, mlb: Tensor, mw: Tensor,
                       mwb: Tensor) -> Tensor:
    """Plain PyTorch version of the forward kernel, same rounding points."""
    _, _, pw, _ = _forward_plain(q, k, v, ml, mlb, mw, mwb)
    return _merge(pw @ _heads(v, ml.shape[0]), q.dtype)


def talking_head_bwd_plain(q: Tensor, k: Tensor, v: Tensor, ml: Tensor, mlb: Tensor, mw: Tensor,
                           mwb: Tensor, dout: Tensor) -> tuple[Tensor, Tensor, Tensor, MixGrads]:
    """Plain PyTorch version of the backward kernel (recompute, then the
    gradients), same rounding points: (dq, dk, dv, mix gradients)."""
    n = ml.shape[0]
    scale = (q.shape[-1] // n) ** -0.5
    raw, p, pw, qs = _forward_plain(q, k, v, ml, mlb, mw, mwb)
    go = _heads(dout, n)
    dv = pw.transpose(-1, -2) @ go
    dmixw = go @ _heads(v, n).transpose(-1, -2)
    dmw = torch.einsum("bgts,bhts->gh", dmixw, p)
    dp = _mix(mw.t(), dmixw)
    dmixl = p * (dp - (dp * p).sum(-1, keepdim=True))
    dml = torch.einsum("bgts,bhts->gh", dmixl, raw)
    draw = _mix(ml.t(), dmixl)
    dq = (draw @ _heads(k, n)) * scale
    dk = draw.transpose(-1, -2) @ qs
    grads = MixGrads(dml, dmixl.sum((0, 2, 3)), dmw, dmixw.sum((0, 2, 3)))
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype), grads


def _check_cuda_args(q: Tensor, k: Tensor, v: Tensor, n_heads: int) -> None:
    B, T, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError("talking_head_attention: q, k and v must share one type, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != D or D % n_heads:
        raise ValueError(f"talking_head_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit {n_heads} heads")
    if not use_talking_head_kernel(T, k.shape[1], n_heads, D // n_heads):
        raise ValueError(f"talking_head_attention: no CUDA kernel for t={T}, s={k.shape[1]}, "
                         f"n_heads={n_heads}, head_dim={D // n_heads}; gate calls with "
                         "use_talking_head_kernel()")


def _pad_heads(t: Tensor, n_heads: int) -> Tensor:
    """(B, T, N·H) → (B, T, N·Hp), each head zero-padded to ``padded_head``."""
    B, T, D = t.shape
    hd = D // n_heads
    if padded_head(hd) == hd:
        return t.contiguous()
    t = t.reshape(B, T, n_heads, hd)
    return torch.nn.functional.pad(t, (0, padded_head(hd) - hd)).reshape(B, T, -1)


def _unpad_heads(t: Tensor, n_heads: int, hd: int) -> Tensor:
    """The inverse of ``_pad_heads``: the first ``hd`` columns of each head."""
    B, T, Dp = t.shape
    if Dp == n_heads * hd:
        return t
    return t.reshape(B, T, n_heads, -1)[..., :hd].reshape(B, T, n_heads * hd)


def _mix_buffer(ml: Tensor, mlb: Tensor, mw: Tensor, mwb: Tensor) -> Tensor:
    """ml, mlb, mw, mwb flattened into one contiguous f32 buffer, the
    kernels' layout."""
    return torch.cat([t.float().reshape(-1) for t in (ml, mlb, mw, mwb)])


def talking_head_cuda(q: Tensor, k: Tensor, v: Tensor, ml: Tensor, mlb: Tensor, mw: Tensor,
                      mwb: Tensor) -> Tensor:
    """Launch ``csrc/talking_head.cu`` on the current stream (heads padded
    to a multiple of 16 around it)."""
    n = ml.shape[0]
    _check_cuda_args(q, k, v, n)
    B, T, D = q.shape
    hd = D // n
    if q.numel() == 0:
        return torch.empty_like(q)
    q, k, v = (_pad_heads(t, n) for t in (q, k, v))
    mix = _mix_buffer(ml, mlb, mw, mwb)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _cuda.lib().vtt_talking_head_fwd(
            _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), int(q.dtype == torch.bfloat16),
            _cuda.ptr(mix), _cuda.ptr(out), B, T, k.shape[1], n, padded_head(hd),
            float(hd**-0.5), _cuda.stream(),
        )
        _cuda.check(err, "talking_head_attention")
    _cuda.LAUNCHES["talking_head"] += 1
    return _unpad_heads(out, n, hd)


def talking_head_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, ml: Tensor, mlb: Tensor, mw: Tensor,
                          mwb: Tensor, dout: Tensor) -> tuple[Tensor, Tensor, Tensor, MixGrads]:
    """Launch ``csrc/talking_head_bwd.cu`` on the current stream (heads
    padded to a multiple of 16 around it)."""
    n = ml.shape[0]
    _check_cuda_args(q, k, v, n)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("talking_head_attention backward: dout must match q in shape and type")
    B, T, D = q.shape
    S, dev, hd = k.shape[1], q.device, D // n
    q, k, v, dout = (_pad_heads(t, n) for t in (q, k, v, dout))
    mix = _mix_buffer(ml, mlb, mw, mwb)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dmix = torch.zeros(2 * n * n + 2 * n, device=dev)
    if q.numel() > 0:
        bf = int(q.dtype == torch.bfloat16)
        with torch.cuda.device(dev):
            # the rows' max, 1/Σe and delta, (B, T, 3, heads) f32, and the row
            # blocks' partial mix-parameter sums: no (B, H, T, S) tensor
            floats = _cuda.lib().vtt_talking_head_bwd_floats(B, T, S, n, padded_head(hd), bf)
            scratch = torch.empty(floats, device=dev)
            err = _cuda.lib().vtt_talking_head_bwd(
                _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(dout), bf, _cuda.ptr(mix),
                _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv), _cuda.ptr(scratch), _cuda.ptr(dmix),
                B, T, S, n, padded_head(hd), float(hd**-0.5), _cuda.stream(),
            )
            _cuda.check(err, "talking_head_attention backward")
        _cuda.LAUNCHES["talking_head_bwd"] += 1
    sizes = (n * n, n, n * n, n)
    dml, dmlb, dmw, dmwb = dmix.split(sizes)
    dq, dk, dv = (_unpad_heads(t, n, hd) for t in (dq, dk, dv))
    return dq, dk, dv, MixGrads(dml.reshape(n, n), dmlb, dmw.reshape(n, n), dmwb)


class TalkingHeadFunction(torch.autograd.Function):
    """Differentiable talking-head attention: the kernels on CUDA tensors,
    the plain versions on CPU tensors or with ``plain``. Gradients for q, k,
    v and the four mix parameters (in their dtypes)."""

    @staticmethod
    def forward(ctx, q, k, v, ml, mlb, mw, mwb, plain):
        fwd = talking_head_plain if plain or not q.is_cuda else talking_head_cuda
        ctx.save_for_backward(q, k, v, ml, mlb, mw, mwb)
        ctx.plain = plain
        return fwd(q, k, v, ml, mlb, mw, mwb)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, ml, mlb, mw, mwb = ctx.saved_tensors
        bwd = talking_head_bwd_plain if ctx.plain or not dout.is_cuda else talking_head_bwd_cuda
        dq, dk, dv, g = bwd(q, k, v, ml, mlb, mw, mwb, dout.to(q.dtype))
        return (dq, dk, dv, g.ml.to(ml.dtype), g.mlb.to(mlb.dtype), g.mw.to(mw.dtype),
                g.mwb.to(mwb.dtype), None)


@torch.library.custom_op("vtt::talking_head_attention", mutates_args=(), device_types="cpu")
def _talking_head_op(q: Tensor, k: Tensor, v: Tensor, ml: Tensor, mlb: Tensor, mw: Tensor,
                     mwb: Tensor) -> Tensor:
    return talking_head_plain(q, k, v, ml, mlb, mw, mwb)


_talking_head_op.register_kernel("cuda")(talking_head_cuda)


@_talking_head_op.register_fake
def _(q, k, v, ml, mlb, mw, mwb):
    return torch.empty_like(q)


def talking_head_attention(q: Tensor, k: Tensor, v: Tensor, ml: Tensor, mlb: Tensor, mw: Tensor,
                           mwb: Tensor, *, plain: bool = False) -> Tensor:
    """Talking-head attention; q: (B, T, N·H), k/v: (B, S, N·H), ml/mw:
    (N, N), mlb/mwb: (N,). Returns (B, T, N·H) in q's type. Differentiable;
    ``plain`` runs the plain PyTorch versions on any device (for checking
    the kernels)."""
    args = (q, k, v, ml, mlb, mw, mwb)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return TalkingHeadFunction.apply(*args, plain)
    if plain:
        return talking_head_plain(*args)
    return _talking_head_op(*args)
