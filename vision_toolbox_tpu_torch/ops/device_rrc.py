"""RandomResizedCrop + horizontal flip on the device, batched — port of
``vision_toolbox_tpu/ops/device_rrc.py`` for the device-resident train set.

The reference runs RandomResizedCrop(176) + RandomHorizontalFlip per sample in
DataLoader worker processes (the reference's data.py:44-52). With the
training set resident on the card (uint8, decoded once), the same transform
is a batched separable resampling:

    out[b] = Wy[b] @ img[b] @ Wx[b]^T      (per channel)

where ``Wy (B, out, H)`` / ``Wx (B, out, W)`` are per-image bilinear (or
antialiased-triangle) weight rows set by that image's crop box and flip bit.
The JAX package computes both contractions with ``einsum`` outside any
Pallas kernel, and so does the port: two batched ``torch.einsum`` products in
float32 (TF32 off, PyTorch's default for matmuls). The only per-step
host→device traffic left is the (B,) index vector.

Box sampling follows torchvision's ``RandomResizedCrop.get_params`` (10
rejection attempts over area-scale × log-uniform aspect, centre-crop
fallback), vectorized: all 10 candidates are drawn at once and the first
valid one is selected with an argmax. Each op is split into *draws*
(``sample_rrc_boxes``, from an explicit ``torch.Generator``) and *apply given
draws* (``crop_resize_flip``), so the tests can feed the JAX package's boxes
to the port. Divergence from torchvision, as in the JAX package: crop
geometry stays continuous (sub-pixel) instead of integer-rounded, and the
source is the fixed squash-resized store rather than the original-resolution
frame (the same trade data/raw_shards.py documents).

Images: NHWC float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor


class RRCDraws(NamedTuple):
    """Per-image crop boxes ``(i, j, h, w)``, float32 (B,) each, in source
    pixels, and the flip bits (B,) bool, or None without a flip."""

    i: Tensor
    j: Tensor
    h: Tensor
    w: Tensor
    flip: Tensor | None


def sample_rrc_boxes(
    generator: torch.Generator, batch: int, src_h: int, src_w: int,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-image crop boxes ``(i, j, h, w)``, float32 (B,) each, on the
    generator's device.

    torchvision semantics (transforms.RandomResizedCrop.get_params): 10
    attempts of ``target_area = area * U(scale)``, aspect ``exp(U(log ratio))``;
    the first attempt with ``h <= src_h and w <= src_w`` wins, else the
    ratio-clamped centre crop.
    """
    dev = generator.device
    u = lambda shape: torch.rand(shape, generator=generator, device=dev)
    area = float(src_h * src_w)
    ta = area * (scale[0] + u((batch, 10)) * (scale[1] - scale[0]))
    lo = torch.log(torch.tensor(ratio[0], dtype=torch.float32)).item()
    hi = torch.log(torch.tensor(ratio[1], dtype=torch.float32)).item()
    r = torch.exp(lo + u((batch, 10)) * (hi - lo))
    w = torch.sqrt(ta * r)
    h = torch.sqrt(ta / r)
    valid = (w <= src_w) & (h <= src_h)  # > 0 by construction
    pick = valid.to(torch.uint8).argmax(dim=1, keepdim=True)  # the first valid attempt
    any_valid = valid.any(dim=1)
    h = h.gather(1, pick)[:, 0]
    w = w.gather(1, pick)[:, 0]

    # fallback: centre crop at the nearest in-range aspect (torchvision's
    # min/max-ratio clamp of the full frame)
    in_ratio = src_w / src_h
    if in_ratio < ratio[0]:
        fb_w, fb_h = float(src_w), src_w / ratio[0]
    elif in_ratio > ratio[1]:
        fb_w, fb_h = src_h * ratio[1], float(src_h)
    else:
        fb_w, fb_h = float(src_w), float(src_h)
    h = torch.where(any_valid, h, fb_h)
    w = torch.where(any_valid, w, fb_w)

    u_i, u_j = u((batch,)), u((batch,))
    i = torch.where(any_valid, u_i * (src_h - h), (src_h - h) / 2)
    j = torch.where(any_valid, u_j * (src_w - w), (src_w - w) / 2)
    return i, j, h, w


def sample_rrc(
    generator: torch.Generator, batch: int, src_h: int, src_w: int,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0), hflip_p: float = 0.5,
) -> RRCDraws:
    """The boxes of ``sample_rrc_boxes`` and, where ``hflip_p > 0``, a flip
    bit per image with probability ``hflip_p``."""
    i, j, h, w = sample_rrc_boxes(generator, batch, src_h, src_w, scale, ratio)
    flip = None
    if hflip_p > 0:
        flip = torch.rand((batch,), generator=generator, device=generator.device) < hflip_p
    return RRCDraws(i, j, h, w, flip)


def _axis_weights(start: Tensor, size: Tensor, src: int, out: int, antialias: bool,
                  flipped: Tensor | None = None) -> Tensor:
    """Triangle-filter resampling rows: (B, out, src) weights for one axis.

    ``start``/``size`` are (B,) crop offsets/extents in source pixels. With
    ``antialias`` the triangle widens by the downscale factor (PIL/torchvision
    antialiased bilinear); at scale 1 both reduce to classic bilinear.
    """
    dev = start.device
    o = torch.arange(out, dtype=torch.float32, device=dev)[None, :]  # (1, out)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, one ulp off the exact quotient that XLA and the CPU take
    step = size[:, None] / torch.full_like(size[:, None], out)  # (B, 1)
    coord = start[:, None] + (o + 0.5) * step - 0.5  # (B, out)
    if flipped is not None:
        flip_coord = start[:, None] + size[:, None] - (o + 0.5) * step - 0.5
        coord = torch.where(flipped[:, None], flip_coord, coord)
    s = torch.clamp(step, min=1.0) if antialias else torch.ones_like(step)
    src_pos = torch.arange(src, dtype=torch.float32, device=dev)[None, None, :]  # (1, 1, src)
    wts = torch.clamp(1.0 - (src_pos - coord[:, :, None]).abs() / s[:, :, None], min=0.0)
    return wts / torch.clamp(wts.sum(-1, keepdim=True), min=1e-8)


def crop_resize_flip(images: Tensor, i: Tensor, j: Tensor, h: Tensor, w: Tensor,
                     flip: Tensor | None, out_size: int, antialias: bool = True) -> Tensor:
    """Resample per-image boxes to (out_size, out_size) with two batched
    products. ``images``: (B, H, W, C) float32; ``i/j/h/w``: (B,) float32
    boxes; ``flip``: (B,) bool or None."""
    B, H, W, C = images.shape
    dev = images.device
    i, j, h, w = (t.to(dev, torch.float32) for t in (i, j, h, w))
    flip = None if flip is None else flip.to(dev)
    wy = _axis_weights(i, h, H, out_size, antialias)  # (B, O, H)
    wx = _axis_weights(j, w, W, out_size, antialias, flipped=flip)  # (B, O, W)
    tmp = torch.einsum("boh,bhwc->bowc", wy, images)
    # einsum may return a permuted view; the warp kernel downstream reads NHWC
    return torch.einsum("bowc,bpw->bopc", tmp, wx).contiguous()


def random_resized_crop_flip(
    generator: torch.Generator, images: Tensor, out_size: int,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0), hflip_p: float = 0.5,
    antialias: bool = True,
) -> Tensor:
    """RandomResizedCrop(out_size) + RandomHorizontalFlip, batched on the
    images' device, with draws from ``generator``."""
    B, H, W, _ = images.shape
    d = sample_rrc(generator, B, H, W, scale, ratio, hflip_p)
    return crop_resize_flip(images, d.i, d.j, d.h, d.w, d.flip, out_size, antialias)

