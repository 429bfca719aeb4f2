"""TrivialAugmentWide on the device, batched — port of
``vision_toolbox_tpu/ops/trivial_augment.py``.

One op per image, drawn uniformly from 14 candidates, magnitude index
uniform in [0, 30], sign ±1 with p = 1/2 (torchvision's TrivialAugmentWide
with its wide ranges). Each op is split into *draws*
(``sample_trivial_augment``, from an explicit ``torch.Generator``) and
*apply given draws* (``trivial_augment_wide_apply``), so the tests can feed
the JAX package's draws to the port.

The geometric ops go through one affine warp (``ops/warp.py``
``affine_warp``: the K1 kernel on CUDA for square images); the pixel ops are
elementwise chains selected per image, and the two heavy ones (sharpness,
equalize) run on a gathered subset of the batch and are scattered back.
``_equalize`` computes torchvision's integer LUT with integer ops, bit for
bit what the JAX package's nibble-matmul formulation gives.

Images: NHWC float32 in [0, 1].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor

NUM_OPS = 14
(
    OP_IDENTITY, OP_SHEAR_X, OP_SHEAR_Y, OP_TRANSLATE_X, OP_TRANSLATE_Y,
    OP_ROTATE, OP_BRIGHTNESS, OP_COLOR, OP_CONTRAST, OP_SHARPNESS,
    OP_POSTERIZE, OP_SOLARIZE, OP_AUTOCONTRAST, OP_EQUALIZE,
) = range(NUM_OPS)

_NUM_MAGNITUDES = 31


class TADraws(NamedTuple):
    """Per-image draws: op id (B,) int, magnitude index (B,) int in [0, 30],
    sign (B,) float ±1."""

    op: Tensor
    mag_idx: Tensor
    sign: Tensor


def sample_trivial_augment(generator: torch.Generator, batch: int) -> TADraws:
    """Draw one op, magnitude and sign per image on the generator's device."""
    dev = generator.device
    op = torch.randint(0, NUM_OPS, (batch,), generator=generator, device=dev)
    mag_idx = torch.randint(0, _NUM_MAGNITUDES, (batch,), generator=generator, device=dev)
    coin = torch.rand((batch,), generator=generator, device=dev) < 0.5
    return TADraws(op, mag_idx, torch.where(coin, 1.0, -1.0))


def _affine_matrices(op: Tensor, mag: Tensor):
    """Per-image 2×3 inverse affine matrix about the image centre; identity
    for non-geometric ops."""
    ones = torch.ones_like(mag)
    shear = mag * 0.99
    t = torch.round(mag * 32.0)
    theta = mag * 135.0 * math.pi / 180.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    is_ = lambda o: (op == o).to(mag.dtype)
    a = torch.where(op == OP_ROTATE, cos, ones)
    b = is_(OP_SHEAR_X) * (-shear) + is_(OP_ROTATE) * sin
    c = is_(OP_SHEAR_Y) * (-shear) + is_(OP_ROTATE) * (-sin)
    d = torch.where(op == OP_ROTATE, cos, ones)
    e = is_(OP_TRANSLATE_X) * (-t)
    f = is_(OP_TRANSLATE_Y) * (-t)
    return a, b, c, d, e, f


def _affine_warp(images: Tensor, op: Tensor, mag: Tensor) -> Tensor:
    """One 2-D bilinear gather pass for the whole batch, zero fill outside."""
    B, H, W, C = images.shape
    a, b, c, d, e, f = (v[:, None, None] for v in _affine_matrices(op, mag.float()))
    ys = torch.arange(H, dtype=torch.float32, device=images.device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=images.device)[None, :].expand(H, W)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    xr, yr = xs - cx, ys - cy
    src_x = a * xr + b * yr + cx + e
    src_y = c * xr + d * yr + cy + f
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx = (src_x - x0)[..., None].to(images.dtype)
    wy = (src_y - y0)[..., None].to(images.dtype)
    flat = images.reshape(B, H * W, C)

    def gather(yi: Tensor, xi: Tensor) -> Tensor:
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()).reshape(B, H * W, 1)
        vals = torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(B, H, W, C)
        return vals * valid[..., None].to(images.dtype)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _grayscale(images: Tensor) -> Tensor:
    r, g, b = images[..., 0:1], images[..., 1:2], images[..., 2:3]
    return 0.2989 * r + 0.587 * g + 0.114 * b


def _blend(img1: Tensor, img2: Tensor, ratio: Tensor) -> Tensor:
    return torch.clamp(img1 * ratio + img2 * (1.0 - ratio), 0.0, 1.0)


def _sharpness_blur(images: Tensor) -> Tensor:
    """torchvision's degenerate image: the 3×3 [[1,1,1],[1,5,1],[1,1,1]]/13
    filter on the interior, border pixels unchanged."""
    B, H, W, C = images.shape
    k = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=images.dtype,
                     device=images.device) / 13.0
    weight = k.expand(C, 1, 3, 3).contiguous()
    blurred = F.conv2d(images.permute(0, 3, 1, 2), weight, padding=1, groups=C).permute(0, 2, 3, 1)
    blurred = torch.clamp(blurred, 0.0, 1.0)
    interior = torch.zeros(H, W, 1, dtype=torch.bool, device=images.device)
    interior[1:H - 1, 1:W - 1] = True
    return torch.where(interior, blurred, images)


def _posterize(images: Tensor, mag01: Tensor) -> Tensor:
    shift = torch.round(mag01 * 6.0).to(torch.int32)  # 8 − bits, bits in 2..8
    v = torch.round(images * 255.0).to(torch.int32)
    mask = ((torch.full_like(shift, 0xFF) >> shift) << shift)[:, None, None, None]
    return (v & mask).to(images.dtype) / 255.0


def _solarize(images: Tensor, mag01: Tensor) -> Tensor:
    threshold = ((1.0 - mag01) * 255.0)[:, None, None, None] / 255.0
    return torch.where(images >= threshold, 1.0 - images, images)


def _autocontrast(images: Tensor) -> Tensor:
    lo = images.amin(dim=(1, 2), keepdim=True)
    hi = images.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), 1.0)
    out = torch.clamp((images - lo) * scale, 0.0, 1.0)
    return torch.where(hi > lo, out, images)


def _equalize(images: Tensor) -> Tensor:
    """Per-channel histogram equalisation with torchvision's integer LUT,
    computed with integer ops (histogram by scatter-add, LUT by gather)."""
    B, H, W, C = images.shape
    v = torch.round(images * 255.0).to(torch.int64)
    flat = v.permute(0, 3, 1, 2).reshape(B * C, H * W)
    hist = torch.zeros(B * C, 256, dtype=torch.int64, device=images.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    # step = (pixel count minus the last nonzero bin's count) // 255
    idx = torch.arange(256, device=images.device)
    last_nonzero = torch.where(hist > 0, idx, -1).amax(dim=1, keepdim=True)
    last_count = torch.where(idx == last_nonzero, hist, 0).amax(dim=1)
    step = (hist.sum(dim=1) - last_count) // 255
    safe_step = torch.clamp(step, min=1)[:, None]
    lut = (torch.cumsum(hist, dim=1) + safe_step // 2) // safe_step
    lut = torch.clamp(F.pad(lut, (1, 0))[:, :-1], 0, 255)  # shift right by one bin
    eq = torch.gather(lut, 1, flat).to(images.dtype)
    eq = eq.reshape(B, C, H, W).permute(0, 2, 3, 1) / 255.0
    return torch.where((step > 0).reshape(B, 1, 1, C), eq, images)


def _subset_capacity(batch: int, n_ops: int) -> int:
    """Fixed gather capacity covering Binomial(batch, n_ops/14) draws with a
    ≥ 6σ margin; an overflowing image keeps the identity op."""
    p = n_ops / NUM_OPS
    mean = batch * p
    sd = math.sqrt(batch * p * (1.0 - p))
    k = int(mean + 6.0 * sd + 8.0)
    return min(batch, -(-k // 8) * 8)


def _sel(op: Tensor, op_id: int) -> Tensor:
    return (op == op_id)[:, None, None, None]


def _apply_pixel_ops(out: Tensor, op: Tensor, mag01: Tensor, signed: Tensor,
                     capacity: int | None = None) -> Tensor:
    """The per-image pixel-op candidates (everything but the warp). Cheap ops
    run branch-free on the whole batch; sharpness and equalize run on a
    fixed-capacity subset gathered by op and scattered back."""
    B = out.shape[0]
    factor = (1.0 + signed * 0.99)[:, None, None, None]
    gray = _grayscale(out)
    mean_gray = torch.round(gray * 255.0).mean(dim=(1, 2, 3), keepdim=True) / 255.0
    cheap = [
        (OP_BRIGHTNESS, _blend(out, torch.zeros_like(out), factor)),
        (OP_COLOR, _blend(out, gray.expand_as(out), factor)),
        (OP_CONTRAST, _blend(out, mean_gray * torch.ones_like(out), factor)),
        (OP_POSTERIZE, _posterize(out, mag01)),
        (OP_SOLARIZE, _solarize(out, mag01)),
        (OP_AUTOCONTRAST, _autocontrast(out)),
    ]
    for op_id, result in cheap:
        out = torch.where(_sel(op, op_id), result, out)

    K = _subset_capacity(B, 2) if capacity is None else capacity
    if K >= B:
        sharp = _blend(out, _sharpness_blur(out), factor)
        out = torch.where(_sel(op, OP_SHARPNESS), sharp, out)
        return torch.where(_sel(op, OP_EQUALIZE), _equalize(out), out)

    member = (op == OP_SHARPNESS) | (op == OP_EQUALIZE)
    idx = torch.argsort((~member).to(torch.int8), stable=True)[:K]  # members first
    sub, sub_op = out[idx], op[idx]
    res = torch.where(_sel(sub_op, OP_SHARPNESS), _blend(sub, _sharpness_blur(sub), factor[idx]),
                      sub)
    res = torch.where(_sel(sub_op, OP_EQUALIZE), _equalize(sub), res)
    return out.index_copy(0, idx, res)


def trivial_augment_wide_apply(images: Tensor, draws: TADraws) -> Tensor:
    """Apply one TrivialAugmentWide op per image, given the draws."""
    from .warp import affine_warp

    dev = images.device
    op = draws.op.to(dev)
    mag01 = draws.mag_idx.to(dev, torch.float32) / (_NUM_MAGNITUDES - 1)  # [0, 1]
    signed = mag01 * draws.sign.to(dev, torch.float32)  # [-1, 1]
    out = affine_warp(images, op, signed)
    return _apply_pixel_ops(out, op, mag01, signed)


def trivial_augment_wide(generator: torch.Generator, images: Tensor) -> Tensor:
    """Apply one TrivialAugmentWide op per image, batched on the device."""
    return trivial_augment_wide_apply(images, sample_trivial_augment(generator, images.shape[0]))
