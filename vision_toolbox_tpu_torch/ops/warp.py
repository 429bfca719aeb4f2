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
  (a block per image and 32 × 32 output tile: a vectorised copy for an
  identity program, else the tile's source footprint staged in shared
  memory and every output pixel recomposing the passes from it; see the
  note there); on a CPU tensor it runs ``shear3_warp_plain``. Both take the
  same program, computed once here on the tensor's device.
- ``stage_footprint``: the kernel's footprint rule, mirrored, for the CPU
  tests: which input rectangle a tile stages and how many floats that
  takes beside the shared memory the kernel sizes (``STAGE_FLOATS``).
- ``affine_warp``: the dispatch. Square images take ``shear3_warp`` on every
  device; non-square ones the 2-D bilinear gather
  (``trivial_augment._affine_warp``). The JAX package takes the gather on
  every device but the TPU, so the two packages agree on CPU only with the
  JAX side pointed at its shear3 warp.

Images are NHWC, H == W for the shear warp, float32 inside.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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


# csrc/warp_shear3.cu's output tile side, the worst staged footprint side
# over the draw set it sizes shared memory for, the floats a staged row may
# add (16-byte ends and the bank pad), and the floats a block stages into
# at C = 3 (``launch``)
TILE = 32
STAGE_EDGE = 76
ROW_PAD = 12
STAGE_FLOATS = STAGE_EDGE * (STAGE_EDGE * 3 + ROW_PAD)


class Footprint(NamedTuple):
    """What a K1 tile stages: image rows and columns (inclusive; parts off
    the image are staged as zeros), and the floats they take as rows of
    ``pitch`` floats."""

    rows: tuple[int, int]
    cols: tuple[int, int]
    floats: int


def _shift_floor(p: float, t: float, idx: int, c: np.float32) -> int:
    """``shear_at``'s k: floor(p·(idx − c) + t), each step rounded to f32."""
    f = np.float32
    return int(np.floor(f(f(f(p) * f(f(idx) - c)) + f(t))))


def _reads(r: tuple[int, int], idx: tuple[int, int], p: float, t: float,
           c: np.float32) -> tuple[int, int]:
    if r[0] > r[1] or idx[0] > idx[1]:
        return 1, 0
    ka, kb = _shift_floor(p, t, idx[0], c), _shift_floor(p, t, idx[1], c)
    return r[0] + min(ka, kb), r[1] + max(ka, kb) + 1


def stage_footprint(prog: tuple, i0: int, j0: int, h: int, w: int) -> Footprint | None:
    """The input rectangle K1 stages for the output tile at (i0, j0) of an
    RGB image with 16-byte rows and program ``prog`` = (k90, p1, t1, p2, t2,
    p3) (floats as the f32 tensors hold them), or None where every column
    pass 3 reads lies off the canvas (``warp_shear3_kernel``'s footprint,
    step by step: pass 3's columns from the tile's rows, clipped to the
    canvas, pass 2's rows from those columns, pass 1's columns from those
    rows, then the rectangle of the quarter-turned canvas as image rows and
    columns)."""
    k90, p1, t1, p2, t2, p3 = prog
    s = canvas_size(h)
    pad = (s - h) // 2
    on1, on2, on3 = p1 != 0 or t1 != 0, p2 != 0 or t2 != 0, p3 != 0
    cen = np.float32(0.5) * np.float32(s - 1)
    rows = (pad + i0, pad + min(i0 + TILE, h) - 1)
    cols = (pad + j0, pad + min(j0 + TILE, w) - 1)
    x3 = _reads(cols, rows, p3 if on3 else 0.0, 0.0, cen)
    x3 = (max(x3[0], 0), min(x3[1], s - 1))
    if x3[0] > x3[1]:
        return None
    y2 = _reads(rows, x3, p2 if on2 else 0.0, t2 if on2 else 0.0, cen)
    x1 = _reads(x3, y2, p1 if on1 else 0.0, t1 if on1 else 0.0, cen)
    ir, ic = (y2[0] - pad, y2[1] - pad), (x1[0] - pad, x1[1] - pad)
    if k90 == 1:
        ir, ic = (s - 1 - x1[1] - pad, s - 1 - x1[0] - pad), (y2[0] - pad, y2[1] - pad)
    elif k90 == -1:
        ir, ic = (x1[0] - pad, x1[1] - pad), (s - 1 - y2[1] - pad, s - 1 - y2[0] - pad)
    nf = (((ic[1] + 1) * 3 + 3) & ~3) - ((ic[0] * 3) & ~3)  # whole 16-byte chunks
    pitch = nf + (4 if (nf // 4) % 2 == 0 else 0)
    return Footprint(ir, ic, (ir[1] - ir[0] + 1) * pitch)


def program_operands(program: Program) -> tuple[Tensor, Tensor]:
    """The kernel's operands of a program: (B, 4) int32 flags [k90, pass 1,
    pass 2, pass 3 on] and (B, 5) f32 coefficients [p1, t1, p2, t2, p3]."""
    k90, p1, t1, p2, t2, p3 = program
    flags = torch.stack(
        [k90.int(), ((p1 != 0) | (t1 != 0)).int(), ((p2 != 0) | (t2 != 0)).int(), (p3 != 0).int()],
        dim=1,
    ).contiguous()
    return flags, torch.stack([p1, t1, p2, t2, p3], dim=1).float().contiguous()


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
    flags, coef = program_operands(program)
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
