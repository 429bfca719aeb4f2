"""Swin's shifted-window relayout (K8) — port of
``vision_toolbox_tpu/ops/swin_relayout.py``.

``shifted_window_partition`` is a cyclic roll by (−s, −s) and the window
partition (B, H, W, C) → (B, nW, w², C) in one read and one write;
``shifted_window_unpartition`` is its inverse. Both are permutations, so each
is the other's gradient, and the kernels are bit-exact.

Without gradients (serving, ``torch.export``) each entry point runs its
custom op (``vtt::swin_window_partition``, ``vtt::swin_window_unpartition``):
on CPU tensors the plain version (``torch.roll`` and reshape/permute), on
CUDA tensors the hand-written kernel in ``csrc/swin_relayout.cu``. Under
autograd it runs ``WindowPartitionFunction`` / ``WindowUnpartitionFunction``,
whose backward is the other direction, the kernel on CUDA tensors and the
plain version on CPU tensors or with ``plain=True``. A CUDA tensor launches
the kernel or raises.

The port runs the kernels at every shifted block (``use_swin_relayout``);
unshifted blocks keep the plain reshape/permute, as the JAX package does
outside its kernel. The JAX package's own dispatch is off (``_ENABLED``, a
v5e measurement).
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import _cuda


def use_swin_relayout(shift: int) -> bool:
    """The kernels run at every shifted block, on every device (on CPU
    tensors as their plain versions)."""
    return shift > 0


def window_partition(x: Tensor, w: int) -> Tensor:
    """(B, H, W, C) → (B, nW, w², C), windows in row-major order."""
    B, H, W, C = x.shape
    if H % w or W % w:
        raise ValueError(f"feature map {H}x{W} not divisible by window {w}; pick img_size so "
                         "every stage grid divides its window size (e.g. 224 for the default "
                         "configs)")
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // w) * (W // w), w * w, C)


def window_unpartition(y: Tensor, w: int, nH: int, nW: int) -> Tensor:
    """(B, nH·nW, w², C) → (B, nH·w, nW·w, C), the inverse of ``window_partition``."""
    B, _, _, C = y.shape
    y = y.reshape(B, nH, nW, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, nH * w, nW * w, C)


def shifted_window_partition_plain(x: Tensor, w: int, shift: int) -> Tensor:
    """Plain PyTorch version of the partition kernel."""
    return window_partition(torch.roll(x, (-shift, -shift), (1, 2)), w)


def shifted_window_unpartition_plain(y: Tensor, w: int, shift: int, H: int, W: int) -> Tensor:
    """Plain PyTorch version of the unpartition kernel."""
    return torch.roll(window_unpartition(y, w, H // w, W // w), (shift, shift), (1, 2))


def _check(B: int, H: int, W: int, C: int, w: int, shift: int, what: str) -> None:
    if w < 1 or H % w or W % w or not 0 <= shift < w or min(B, H, W, C) < 1:
        raise ValueError(f"{what}: no CUDA kernel for a {H}x{W} map in windows of {w} shifted by "
                         f"{shift}; it takes H, W multiples of w and 0 ≤ shift < w")


def _relayout_cuda(fn: str, src: Tensor, out: Tensor, B: int, H: int, W: int, C: int, w: int,
                   shift: int, key: str) -> Tensor:
    src = src.contiguous()
    with torch.cuda.device(src.device):
        err = getattr(_cuda.lib(), fn)(_cuda.ptr(src), _cuda.ptr(out), B, H, W, C,
                                       src.element_size(), w, shift, _cuda.stream())
        _cuda.check(err, key)
    _cuda.LAUNCHES[key] += 1
    return out


def shifted_window_partition_cuda(x: Tensor, w: int, shift: int) -> Tensor:
    """Launch the partition kernel of ``csrc/swin_relayout.cu``."""
    B, H, W, C = x.shape
    _check(B, H, W, C, w, shift, "shifted_window_partition")
    out = torch.empty(B, (H // w) * (W // w), w * w, C, dtype=x.dtype, device=x.device)
    return _relayout_cuda("vtt_swin_partition", x, out, B, H, W, C, w, shift, "swin_partition")


def shifted_window_unpartition_cuda(y: Tensor, w: int, shift: int, H: int, W: int) -> Tensor:
    """Launch the unpartition kernel of ``csrc/swin_relayout.cu``."""
    B, nHW, T, C = y.shape
    _check(B, H, W, C, w, shift, "shifted_window_unpartition")
    if nHW != (H // w) * (W // w) or T != w * w:
        raise ValueError(f"shifted_window_unpartition: y {tuple(y.shape)} is not the windows of "
                         f"a {H}x{W} map in windows of {w}")
    out = torch.empty(B, H, W, C, dtype=y.dtype, device=y.device)
    return _relayout_cuda("vtt_swin_unpartition", y, out, B, H, W, C, w, shift,
                          "swin_unpartition")


def _partition(x: Tensor, w: int, shift: int, plain: bool) -> Tensor:
    if plain or not x.is_cuda:
        return shifted_window_partition_plain(x, w, shift)
    return shifted_window_partition_cuda(x, w, shift)


def _unpartition(y: Tensor, w: int, shift: int, H: int, W: int, plain: bool) -> Tensor:
    if plain or not y.is_cuda:
        return shifted_window_unpartition_plain(y, w, shift, H, W)
    return shifted_window_unpartition_cuda(y, w, shift, H, W)


class WindowPartitionFunction(torch.autograd.Function):
    """The differentiable partition; its backward is the unpartition."""

    @staticmethod
    def forward(ctx, x, w, shift, plain):
        ctx.args = (w, shift, x.shape[1], x.shape[2], plain)
        return _partition(x, w, shift, plain)

    @staticmethod
    def backward(ctx, dy):
        return _unpartition(dy, *ctx.args), None, None, None


class WindowUnpartitionFunction(torch.autograd.Function):
    """The differentiable unpartition; its backward is the partition."""

    @staticmethod
    def forward(ctx, y, w, shift, H, W, plain):
        ctx.args = (w, shift, plain)
        return _unpartition(y, w, shift, H, W, plain)

    @staticmethod
    def backward(ctx, dx):
        return _partition(dx, *ctx.args), None, None, None, None, None


@torch.library.custom_op("vtt::swin_window_partition", mutates_args=(), device_types="cpu")
def _partition_op(x: Tensor, w: int, shift: int) -> Tensor:
    return shifted_window_partition_plain(x, w, shift).contiguous()


_partition_op.register_kernel("cuda")(shifted_window_partition_cuda)


@_partition_op.register_fake
def _(x, w, shift):
    B, H, W, C = x.shape
    return x.new_empty(B, (H // w) * (W // w), w * w, C)


@torch.library.custom_op("vtt::swin_window_unpartition", mutates_args=(), device_types="cpu")
def _unpartition_op(y: Tensor, w: int, shift: int, H: int, W: int) -> Tensor:
    return shifted_window_unpartition_plain(y, w, shift, H, W).contiguous()


_unpartition_op.register_kernel("cuda")(shifted_window_unpartition_cuda)


@_unpartition_op.register_fake
def _(y, w, shift, H, W):
    return y.new_empty(y.shape[0], H, W, y.shape[-1])


def shifted_window_partition(x: Tensor, w: int, shift: int, *, plain: bool = False) -> Tensor:
    """``window_partition(torch.roll(x, (−shift, −shift), (1, 2)), w)`` in
    one read and one write: (B, H, W, C) → (B, nW, w², C). Differentiable;
    ``plain`` runs the plain PyTorch versions on any device."""
    if torch.is_grad_enabled() and x.requires_grad:
        return WindowPartitionFunction.apply(x, w, shift, plain)
    if plain:
        return shifted_window_partition_plain(x, w, shift)
    return _partition_op(x, w, shift)


def shifted_window_unpartition(y: Tensor, w: int, shift: int, H: int, W: int, *,
                               plain: bool = False) -> Tensor:
    """``torch.roll(window_unpartition(y, w, H/w, W/w), (shift, shift), (1,
    2))`` in one read and one write: (B, nW, w², C) → (B, H, W, C).
    Differentiable; ``plain`` runs the plain PyTorch versions on any device."""
    if torch.is_grad_enabled() and y.requires_grad:
        return WindowUnpartitionFunction.apply(y, w, shift, H, W, plain)
    if plain:
        return shifted_window_unpartition_plain(y, w, shift, H, W)
    return _unpartition_op(y, w, shift, H, W)
