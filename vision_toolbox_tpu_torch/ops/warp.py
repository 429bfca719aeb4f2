"""Affine warp for TrivialAugment's geometric ops — port of
``vision_toolbox_tpu/ops/warp.py`` and the TPU kernel K1
(``vision_toolbox_tpu/ops/warp_pallas.py`` ``shear3_warp_pallas``).

Every geometric op of the TA set (identity, shear X/Y, translate X/Y,
rotate) factors into an optional quarter turn and at most three 1-D shear
passes, ``R(−θ) = ShX(tan θ/2)·ShY(−sin θ)·ShX(tan θ/2)``; rotations are
reduced to |θ'| ≤ 45° first, so every shear factor is at most tan 22.5°.

- ``shear3_params``: the per-image program (k90, p1, t1, p2, t2, p3).
- ``shear3_warp_plain``: the three passes in plain PyTorch on a zero-padded
  ``canvas_size(H)`` canvas, the counterpart of ``shear3_warp_xla``.
- ``shear3_warp``: K1. On a CUDA tensor it launches ``csrc/warp_shear3.cu``
  (one thread per output pixel recomposes the passes; see the note there);
  on a CPU tensor it runs ``shear3_warp_plain``. Both take the same program,
  computed once here on the tensor's device.
- ``affine_warp``: the dispatch. Square images take ``shear3_warp`` on every
  device; non-square ones the 2-D bilinear gather
  (``trivial_augment._affine_warp``). The JAX package takes the gather on
  every device but the TPU, so the two packages agree on CPU only with the
  JAX side pointed at its shear3 warp.

Images are NHWC, H == W for the shear warp, float32 inside.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from . import _cuda
from .trivial_augment import (
    OP_ROTATE,
    OP_SHEAR_X,
    OP_SHEAR_Y,
    OP_TRANSLATE_X,
    OP_TRANSLATE_Y,
)

Program = tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]


def canvas_size(h: int) -> int:
    """Smallest power of two ≥ h + 2·(intermediate excursion bound): a 45°
    rotation's shear passes push content up to ~0.65·h outside the frame
    (``warp_pallas.py`` ``canvas_size``; 512 at 176 px)."""
    need = h + 2 * (int(0.65 * h) + 2)
    s = 128
    while s < need:
        s *= 2
    return s


def shear3_params(op: Tensor, mag: Tensor) -> Program:
    """Per-image shear program (k90, p1, t1, p2, t2, p3) of the inverse warp
    ``src = S1(p1, t1)·S2(p2, t2)·S3(p3)·out`` about the image centre.
    ``mag`` is the signed magnitude in [-1, 1] (f32): shear ±0.99, translate
    ±32 px (rounded), rotate ±135°."""
    mag = mag.float()
    shear = mag * 0.99
    t = torch.round(mag * 32.0)
    theta = mag * (135.0 * math.pi / 180.0)
    is_rot = op == OP_ROTATE
    zeros = torch.zeros_like(mag)
    k90 = torch.where(is_rot, torch.clamp(torch.round(theta / (math.pi / 2)), -1, 1), zeros)
    tp = theta - k90 * (math.pi / 2)
    p1 = torch.where(is_rot, torch.tan(tp / 2), torch.where(op == OP_SHEAR_X, -shear, zeros))
    p2 = torch.where(is_rot, -torch.sin(tp), torch.where(op == OP_SHEAR_Y, -shear, zeros))
    p3 = torch.where(is_rot, torch.tan(tp / 2), zeros)
    t1 = torch.where(op == OP_TRANSLATE_X, -t, zeros)
    t2 = torch.where(op == OP_TRANSLATE_Y, -t, zeros)
    return k90.to(torch.int32), p1, t1, p2, t2, p3


def _quarter_turn(canvas: Tensor, k90: Tensor) -> Tensor:
    """Per-image quarter turn of a square (B, S, S, C) canvas:
    k90 = +1: c0[y, x] = in[S-1-x, y]; k90 = -1: c0[y, x] = in[x, S-1-y]."""
    t = canvas.transpose(1, 2)
    sel = k90.reshape(-1, 1, 1, 1)
    return torch.where(sel == 1, t.flip(2), torch.where(sel == -1, t.flip(1), canvas))


def _xpass(cv: Tensor, delta: Tensor) -> Tensor:
    """One shear pass along axis 2: out[b, y, x] = lerp(in[b, y, x+k],
    in[b, y, x+k+1], f) with δ = k + f per (b, y) and zero outside."""
    B, S, W, C = cv.shape
    k = torch.floor(delta)
    f = (delta - k)[..., None, None]
    src = torch.arange(W, device=cv.device)[None, None, :] + k.long()[..., None]  # (B, S, W)

    def tap(idx: Tensor) -> Tensor:
        valid = ((idx >= 0) & (idx < W))[..., None]
        g = torch.gather(cv, 2, idx.clamp(0, W - 1)[..., None].expand(-1, -1, -1, C))
        return torch.where(valid, g, torch.zeros((), dtype=cv.dtype, device=cv.device))

    return tap(src) * (1.0 - f) + tap(src + 1) * f


def shear3_warp_plain(images: Tensor, program: Program) -> Tensor:
    """The three passes in plain PyTorch (f32, NHWC, H == W), given the
    program from ``shear3_params``."""
    B, H, W, C = images.shape
    if H != W:
        raise ValueError(f"shear3 warp expects square images, got {H}×{W}")
    S = canvas_size(H)
    P = (S - H) // 2
    k90, p1, t1, p2, t2, p3 = program
    canvas = torch.zeros(B, S, S, C, dtype=torch.float32, device=images.device)
    canvas[:, P:P + H, P:P + W] = images.float()
    canvas = _quarter_turn(canvas, k90)
    ys = (torch.arange(S, dtype=torch.float32, device=images.device) - (S - 1) / 2.0)[None, :]
    canvas = _xpass(canvas, p1[:, None] * ys + t1[:, None])
    canvas = _xpass(canvas.transpose(1, 2), p2[:, None] * ys + t2[:, None]).transpose(1, 2)
    canvas = _xpass(canvas, p3[:, None] * ys)
    return canvas[:, P:P + H, P:P + W].contiguous()


def shear3_warp_cuda(images: Tensor, program: Program) -> Tensor:
    """Launch ``csrc/warp_shear3.cu`` on the current stream."""
    if images.dtype != torch.float32:
        raise TypeError(f"shear3_warp: images must be float32, got {images.dtype}")
    if images.ndim != 4 or images.shape[1] != images.shape[2]:
        raise ValueError(f"shear3_warp: expects square NHWC images, got {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("shear3_warp: images must be contiguous NHWC")
    B, H, W, C = images.shape
    S = canvas_size(H)
    k90, p1, t1, p2, t2, p3 = program
    flags = torch.stack(
        [k90.int(), ((p1 != 0) | (t1 != 0)).int(), ((p2 != 0) | (t2 != 0)).int(), (p3 != 0).int()],
        dim=1,
    ).contiguous()
    coef = torch.stack([p1, t1, p2, t2, p3], dim=1).float().contiguous()
    out = torch.empty_like(images)
    if images.numel() == 0:
        return out
    with torch.cuda.device(images.device):
        err = _cuda.lib().vtt_warp_shear3(
            _cuda.ptr(images), _cuda.ptr(out), _cuda.ptr(flags), _cuda.ptr(coef),
            B, H, W, C, S, (S - H) // 2, _cuda.stream(),
        )
        _cuda.check(err, "shear3_warp")
    _cuda.LAUNCHES["warp_shear3"] += 1
    return out


def shear3_warp(images: Tensor, op: Tensor, mag: Tensor) -> Tensor:
    """Three-shear affine warp (K1): NHWC f32 images with H == W, per-image
    ``op`` and signed ``mag``. A CUDA tensor launches the kernel or raises; a
    CPU tensor runs the plain version."""
    program = shear3_params(op.to(images.device), mag.to(images.device))
    if images.is_cuda:
        return shear3_warp_cuda(images, program)
    return shear3_warp_plain(images, program)


def affine_warp(images: Tensor, op: Tensor, mag: Tensor) -> Tensor:
    """The geometric pass of TrivialAugment: the three-shear warp for square
    images, the exact 2-D bilinear gather otherwise."""
    if images.shape[1] == images.shape[2]:
        return shear3_warp(images, op, mag)
    from .trivial_augment import _affine_warp

    return _affine_warp(images, op, mag)
