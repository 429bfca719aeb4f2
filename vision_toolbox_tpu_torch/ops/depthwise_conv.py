"""Depthwise k×k convolution, stride 1, SAME (K9 forward and backward) —
port of ``vision_toolbox_tpu/ops/depthwise_conv.py``.

Layouts are the JAX package's: x (B, H, W, C) NHWC, w (k, k, 1, C) HWIO
(flax's depthwise ``nn.Conv`` kernel), odd k.

``depthwise_conv2d`` is the entry point. Without gradients (serving,
``torch.export``) it runs the custom op ``vtt::depthwise_conv2d``: on CPU
tensors ``depthwise_conv2d_plain``, on CUDA tensors the hand-written kernel
in ``csrc/depthwise_conv.cu``. Under autograd it runs
``DepthwiseConvFunction``, whose backward is the kernels in
``csrc/depthwise_conv_bwd.cu`` on CUDA tensors and
``depthwise_conv2d_bwd_plain`` on CPU tensors or with ``plain=True``. A CUDA
tensor launches the kernels or raises; nothing falls back to cuDNN or to the
plain versions.

Rounding points are the TPU kernels' (``_fwd_kernel``, ``_bwd_kernel``):
every tap is x·w in f32 from the stored types, the k² taps are summed in f32
with dy outer and dx inner, and the output is rounded once to x's type; dx
is the same sum over the cotangent with the flipped kernel; dw is the f32
sum over batch and space of xpad·g per tap, returned in w's type. The JAX
package's default dispatch runs ``lax.conv_general_dilated`` instead (its
``use_depthwise_kernel`` is off, a v5e measurement), which rounds at other
points; the port runs this kernel at every stride-1 depthwise conv.

The kernels move their operands with 16-byte copies where C and the
pointers allow and one element at a time otherwise; ``kernel_route`` asks the
library which a call takes, and ``kernel_geometry`` how it tiles the map.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import Tensor

from . import _cuda

MAX_KERNEL = 21  # csrc/depthwise_conv.cuh MAX_K: one-warp regions of (7 + k − 1)² fit 227 KB
_INT_MAX = 2**31 - 1  # the C interface takes B, H, W and C as int
GEOMETRY_KEYS = ("tile_rows", "tile_cols", "images", "stages", "blocks_per_group",
                 "regions_per_block", "threads", "smem_bytes")


def use_depthwise_kernel(k: int, stride: int = 1, dilation: int = 1) -> bool:
    """Shape rule of the CUDA kernels: odd k up to 21, stride 1, dilation 1,
    any channel count (ConvNeXt's 7, MBConv's 3 and 5, PatchConvNet's 3)."""
    return k % 2 == 1 and 1 <= k <= MAX_KERNEL and stride == 1 and dilation == 1


def _taps(xp: Tensor, w: Tensor, H: int, W: int) -> Tensor:
    """Σ_dy Σ_dx xp[:, dy:dy+H, dx:dx+W]·w[dy, dx] in f32, dy outer and dx
    inner, each tap's product and sum rounded (the kernels' order)."""
    k = w.shape[0]
    w = w.float().reshape(k, k, -1)
    acc = torch.zeros(xp.shape[0], H, W, xp.shape[-1], dtype=torch.float32, device=xp.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy:dy + H, dx:dx + W].float() * w[dy, dx]
    return acc


def _pad(x: Tensor, p: int) -> Tensor:
    return F.pad(x, (0, 0, p, p, p, p))


def depthwise_conv2d_plain(x: Tensor, w: Tensor) -> Tensor:
    """Plain PyTorch version of the forward kernel, same rounding points."""
    B, H, W, C = x.shape
    return _taps(_pad(x, w.shape[0] // 2), w, H, W).to(x.dtype)


def depthwise_conv2d_bwd_plain(x: Tensor, w: Tensor, g: Tensor) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the backward kernels: (dx in x's type, dw
    (k, k, 1, C) in w's type)."""
    B, H, W, C = x.shape
    k = w.shape[0]
    p = k // 2
    dx = _taps(_pad(g, p), w.flip(0, 1), H, W).to(x.dtype)
    xp, g32 = _pad(x, p).float(), g.float()
    dw = torch.stack([(xp[:, dy:dy + H, dx:dx + W] * g32).sum((0, 1, 2))
                      for dy in range(k) for dx in range(k)])
    return dx, dw.reshape(k, k, 1, C).to(w.dtype)


def _check_cuda_args(x: Tensor, w: Tensor) -> tuple[int, int, int, int, int]:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"depthwise_conv2d: x {tuple(x.shape)} must be (B, H, W, C) and "
                         f"w {tuple(w.shape)} (k, k, 1, C)")
    B, H, W, C = x.shape
    k = w.shape[0]
    if w.shape != (k, k, 1, C) or not use_depthwise_kernel(k):
        raise ValueError(f"depthwise_conv2d: no CUDA kernel for w {tuple(w.shape)} on x "
                         f"{tuple(x.shape)}; it takes (k, k, 1, C) with odd k ≤ {MAX_KERNEL} "
                         "(gate calls with use_depthwise_kernel())")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"depthwise_conv2d: {name} must be float32 or bfloat16, got {t.dtype}")
    if max(B, H, W, C) > _INT_MAX:
        raise ValueError(f"depthwise_conv2d: x {tuple(x.shape)} has a dimension beyond the "
                         f"library's int arguments ({_INT_MAX})")
    return B, H, W, C, k


def _ptr(t: Tensor) -> int:
    """An operand's pointer: the kernels take any element-aligned view."""
    return _cuda.ptr(t, t.element_size())


def _is_bf16(t: Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def kernel_route(x: Tensor, g: Tensor | None = None) -> str:
    """The route a call on these operands takes (x, and the cotangent g for
    the backward; the outputs are the wrappers' own, 16-byte-aligned), as
    the library's launchers choose it: ``"wide"`` (16-byte copies in and,
    for bf16, out) or ``"scalar"`` (one element at a time)."""
    wide = _cuda.lib().vtt_dw_route(_ptr(x), None if g is None else _ptr(g), _is_bf16(x),
                                    x.shape[-1])
    return "wide" if wide else "scalar"


def kernel_geometry(x: Tensor, w: Tensor, bwd: bool = False) -> dict[str, int]:
    """The launch geometry (GEOMETRY_KEYS) of the forward kernel, or of the
    weight-gradient kernel with ``bwd``, for these operands on their card."""
    B, H, W, C, k = _check_cuda_args(x, w)
    out = (ctypes.c_longlong * len(GEOMETRY_KEYS))()
    with torch.cuda.device(x.device):
        _cuda.check(_cuda.lib().vtt_dw_geometry(B, H, W, C, k, _is_bf16(x), _is_bf16(w),
                                                int(bwd), out), "depthwise_conv2d geometry")
    return dict(zip(GEOMETRY_KEYS, out))


def depthwise_conv2d_cuda(x: Tensor, w: Tensor) -> Tensor:
    """Launch ``csrc/depthwise_conv.cu`` on the current stream."""
    B, H, W, C, k = _check_cuda_args(x, w)
    x, w = x.contiguous(), w.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = _cuda.lib().vtt_dw_fwd(_ptr(x), _ptr(w), _ptr(y), _is_bf16(x), _is_bf16(w),
                                     B, H, W, C, k, _cuda.stream())
        _cuda.check(err, "depthwise_conv2d")
    _cuda.LAUNCHES["depthwise_conv"] += 1
    return y


def depthwise_conv2d_bwd_cuda(x: Tensor, w: Tensor, g: Tensor) -> tuple[Tensor, Tensor]:
    """Launch ``csrc/depthwise_conv_bwd.cu`` (dx, the dw block partials and
    their fixed-order sum) on the current stream."""
    B, H, W, C, k = _check_cuda_args(x, w)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("depthwise_conv2d backward: g must match x in shape and dtype")
    x, w, g = x.contiguous(), w.contiguous(), g.contiguous()
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if x.numel() == 0:
        return dx, dw.zero_()
    with torch.cuda.device(x.device):
        n = _cuda.lib().vtt_dw_partial_floats(B, H, W, C, k, _is_bf16(x))
        if n < 0:
            _cuda.check(-n, "depthwise_conv2d backward")
        partials = torch.empty(n, dtype=torch.float32, device=x.device)
        err = _cuda.lib().vtt_dw_bwd(_ptr(x), _ptr(g), _ptr(w), _ptr(dx), _ptr(dw),
                                     _ptr(partials), _is_bf16(x), _is_bf16(w), B, H, W, C, k,
                                     _cuda.stream())
        _cuda.check(err, "depthwise_conv2d backward")
    _cuda.LAUNCHES["depthwise_conv_bwd"] += 1
    return dx, dw


class DepthwiseConvFunction(torch.autograd.Function):
    """The differentiable depthwise conv: the kernels on CUDA tensors, the
    plain versions on CPU tensors or with ``plain``. Saves x and w, as the
    JAX custom VJP does."""

    @staticmethod
    def forward(ctx, x, w, plain):
        fwd = depthwise_conv2d_plain if plain or not x.is_cuda else depthwise_conv2d_cuda
        ctx.save_for_backward(x, w)
        ctx.plain = plain
        return fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        bwd = depthwise_conv2d_bwd_plain if ctx.plain or not g.is_cuda else depthwise_conv2d_bwd_cuda
        return (*bwd(x, w, g), None)


@torch.library.custom_op("vtt::depthwise_conv2d", mutates_args=(), device_types="cpu")
def _depthwise_conv_op(x: Tensor, w: Tensor) -> Tensor:
    return depthwise_conv2d_plain(x, w)


_depthwise_conv_op.register_kernel("cuda")(depthwise_conv2d_cuda)


@_depthwise_conv_op.register_fake
def _(x, w):
    return torch.empty_like(x)


def depthwise_conv2d(x: Tensor, w: Tensor, *, plain: bool = False) -> Tensor:
    """Depthwise conv of NHWC ``x`` with (k, k, 1, C) ``w``, stride 1, SAME;
    the output in x's type. Differentiable; ``plain`` runs the plain PyTorch
    versions on any device (for checking the kernels)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return DepthwiseConvFunction.apply(x, w, plain)
    if plain:
        return depthwise_conv2d_plain(x, w)
    return _depthwise_conv_op(x, w)
