"""The train step's input pipeline in plain PyTorch, f32: the draws and the
ops of one step of the recipe, written down once here and frozen.

The draw code is a frozen copy of the recipe's draw order and semantics
(the program draws the same numbers from the same seeded generator):

1. crop boxes and flips (torchvision ``RandomResizedCrop.get_params``, ten
   attempts at once, the first valid one, else the ratio-clamped centre
   crop; a flip bit with p = 1/2);
2. TrivialAugmentWide: op uniform over 14, magnitude index over 31, sign;
3. RandomErasing: apply bit, area, log aspect, top and left uniforms, the
   N(0, 1) fill;
4. CutMix⊕MixUp: one int64 from the generator seeds a numpy generator,
   which draws the coin, λ ~ Beta(α, α) and the CutMix box centre.

The ops: a separable antialiased-triangle resample of each crop box;
TrivialAugment's geometric ops as a quarter turn and three 1-D shears on a
zero-padded canvas (the recipe defines the warp so), its pixel ops; the
erasing box; CutMix or MixUp with each row's partner the batch rolled by
one. Images are NHWC float32 in [0, 1].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

NUM_OPS, NUM_MAGNITUDES = 14, 31
(IDENTITY, SHEAR_X, SHEAR_Y, TRANSLATE_X, TRANSLATE_Y, ROTATE, BRIGHTNESS, COLOR, CONTRAST,
 SHARPNESS, POSTERIZE, SOLARIZE, AUTOCONTRAST, EQUALIZE) = range(NUM_OPS)


def step_seed(seed: int, step: int) -> int:
    """The recipe's seed of train step ``step``: a 63-bit word from numpy's
    generator seeded with ``[seed, step]``."""
    return int(np.random.default_rng([seed, step]).integers(2**63))


class Draws(NamedTuple):
    crop: tuple  # i, j, h, w (B,) f32 and flip (B,) bool
    ta: tuple  # op, magnitude index, sign (B,)
    erase: tuple  # apply, area, log ratio, top u, left u (B,), noise (B, H, W, C)
    mix: tuple  # use_cutmix, lam, r_x, r_y


def draw_step(g: torch.Generator, batch: int, src: int, crop: int, erase_p: float,
              cutmix_alpha: float, mixup_alpha: float) -> Draws:
    dev = g.device
    u = lambda shape: torch.rand(shape, generator=g, device=dev)
    # 1. crop boxes, ten candidates an image
    area = float(src * src)
    ta = area * (0.08 + u((batch, 10)) * (1.0 - 0.08))
    lo = torch.log(torch.tensor(3.0 / 4.0, dtype=torch.float32)).item()
    hi = torch.log(torch.tensor(4.0 / 3.0, dtype=torch.float32)).item()
    r = torch.exp(lo + u((batch, 10)) * (hi - lo))
    w, h = torch.sqrt(ta * r), torch.sqrt(ta / r)
    valid = (w <= src) & (h <= src)
    pick = valid.to(torch.uint8).argmax(dim=1, keepdim=True)
    ok = valid.any(dim=1)
    h = torch.where(ok, h.gather(1, pick)[:, 0], float(src))
    w = torch.where(ok, w.gather(1, pick)[:, 0], float(src))
    ui, uj = u((batch,)), u((batch,))
    i = torch.where(ok, ui * (src - h), (src - h) / 2)
    j = torch.where(ok, uj * (src - w), (src - w) / 2)
    flip = u((batch,)) < 0.5
    # 2. TrivialAugmentWide
    op = torch.randint(0, NUM_OPS, (batch,), generator=g, device=dev)
    mag = torch.randint(0, NUM_MAGNITUDES, (batch,), generator=g, device=dev)
    sign = torch.where(u((batch,)) < 0.5, 1.0, -1.0)
    # 3. RandomErasing
    erase = None
    if erase_p > 0:
        uu = lambda a, b: a + u((batch,)) * (b - a)
        erase = (u((batch,)) < erase_p, uu(0.02, 0.33) * (crop * crop),
                 uu(math.log(0.3), math.log(3.3)), u((batch,)), u((batch,)),
                 torch.randn((batch, crop, crop, 3), generator=g, device=dev))
    # 4. CutMix⊕MixUp, per batch, on the host
    seed = torch.randint(0, 2**62, (1,), generator=g, device=dev)
    rng = np.random.default_rng(int(seed.item()))
    if rng.random() < 0.5:
        mix = (True, float(rng.beta(cutmix_alpha, cutmix_alpha)),
               int(rng.integers(0, crop)), int(rng.integers(0, crop)))
    else:
        mix = (False, float(rng.beta(mixup_alpha, mixup_alpha)), 0, 0)
    return Draws((i, j, h, w, flip), (op, mag, sign), erase, mix)


# -- RandomResizedCrop + flip -------------------------------------------------

def _axis_weights(start: Tensor, size: Tensor, src: int, out: int,
                  flipped: Tensor | None = None) -> Tensor:
    o = torch.arange(out, dtype=torch.float32, device=start.device)[None, :]
    step = size[:, None] / torch.full_like(size[:, None], out)
    coord = start[:, None] + (o + 0.5) * step - 0.5
    if flipped is not None:
        coord = torch.where(flipped[:, None], start[:, None] + size[:, None] - (o + 0.5) * step
                            - 0.5, coord)
    s = torch.clamp(step, min=1.0)
    pos = torch.arange(src, dtype=torch.float32, device=start.device)[None, None, :]
    wts = torch.clamp(1.0 - (pos - coord[:, :, None]).abs() / s[:, :, None], min=0.0)
    return wts / torch.clamp(wts.sum(-1, keepdim=True), min=1e-8)


def crop_resize_flip(images: Tensor, crop: tuple, out: int) -> Tensor:
    i, j, h, w, flip = crop
    _, H, W, _ = images.shape
    wy = _axis_weights(i, h, H, out)
    wx = _axis_weights(j, w, W, out, flip)
    return torch.einsum("bowc,bpw->bopc", torch.einsum("boh,bhwc->bowc", wy, images), wx)


# -- TrivialAugmentWide -------------------------------------------------------

def canvas_size(h: int) -> int:
    need, s = h + 2 * (int(0.65 * h) + 2), 128
    while s < need:
        s *= 2
    return s


def _xpass(cv: Tensor, delta: Tensor) -> Tensor:
    """out[b, y, x] = lerp of in[b, y, x + k] and in[b, y, x + k + 1] by f,
    δ = k + f per (b, y), zero outside."""
    B, S, W, C = cv.shape
    k = torch.floor(delta)
    f = (delta - k)[..., None, None]
    src = torch.arange(W, device=cv.device)[None, None, :] + k.long()[..., None]

    def tap(idx: Tensor) -> Tensor:
        valid = ((idx >= 0) & (idx < W))[..., None]
        val = torch.gather(cv, 2, idx.clamp(0, W - 1)[..., None].expand(-1, -1, -1, C))
        return torch.where(valid, val, torch.zeros((), device=cv.device))

    return tap(src) * (1.0 - f) + tap(src + 1) * f


def warp(images: Tensor, op: Tensor, signed: Tensor) -> Tensor:
    """Shear ±0.99, translate ±32 px, rotate ±135° about the centre: a quarter
    turn and three shears, R(−θ) = ShX(tan θ/2)·ShY(−sin θ)·ShX(tan θ/2)."""
    B, H, W, C = images.shape
    shear, t = signed * 0.99, torch.round(signed * 32.0)
    theta = signed * (135.0 * math.pi / 180.0)
    rot, z = op == ROTATE, torch.zeros_like(signed)
    k90 = torch.where(rot, torch.clamp(torch.round(theta / (math.pi / 2)), -1, 1), z)
    tp = theta - k90 * (math.pi / 2)
    p1 = torch.where(rot, torch.tan(tp / 2), torch.where(op == SHEAR_X, -shear, z))
    p2 = torch.where(rot, -torch.sin(tp), torch.where(op == SHEAR_Y, -shear, z))
    p3 = torch.where(rot, torch.tan(tp / 2), z)
    t1 = torch.where(op == TRANSLATE_X, -t, z)
    t2 = torch.where(op == TRANSLATE_Y, -t, z)
    S = canvas_size(H)
    P = (S - H) // 2
    cv = torch.zeros(B, S, S, C, device=images.device)
    cv[:, P:P + H, P:P + W] = images
    tr, sel = cv.transpose(1, 2), k90.reshape(-1, 1, 1, 1)
    cv = torch.where(sel == 1, tr.flip(2), torch.where(sel == -1, tr.flip(1), cv))
    ys = (torch.arange(S, dtype=torch.float32, device=images.device) - (S - 1) / 2.0)[None, :]
    cv = _xpass(cv, p1[:, None] * ys + t1[:, None])
    cv = _xpass(cv.transpose(1, 2), p2[:, None] * ys + t2[:, None]).transpose(1, 2)
    cv = _xpass(cv, p3[:, None] * ys)
    return cv[:, P:P + H, P:P + W]


def _blend(a: Tensor, b: Tensor, ratio: Tensor) -> Tensor:
    return torch.clamp(a * ratio + b * (1.0 - ratio), 0.0, 1.0)


def _gray(x: Tensor) -> Tensor:
    return 0.2989 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]


def _sharp_blur(x: Tensor) -> Tensor:
    B, H, W, C = x.shape
    k = torch.tensor([[1., 1., 1.], [1., 5., 1.], [1., 1., 1.]], device=x.device) / 13.0
    y = F.conv2d(x.permute(0, 3, 1, 2), k.expand(C, 1, 3, 3).contiguous(), padding=1, groups=C)
    y = torch.clamp(y.permute(0, 2, 3, 1), 0.0, 1.0)
    inner = torch.zeros(H, W, 1, dtype=torch.bool, device=x.device)
    inner[1:H - 1, 1:W - 1] = True
    return torch.where(inner, y, x)


def _equalize(x: Tensor) -> Tensor:
    """torchvision's per-channel equalisation LUT, in integers."""
    B, H, W, C = x.shape
    v = torch.round(x * 255.0).long().permute(0, 3, 1, 2).reshape(B * C, H * W)
    hist = torch.zeros(B * C, 256, dtype=torch.long, device=x.device)
    hist.scatter_add_(1, v, torch.ones_like(v))
    idx = torch.arange(256, device=x.device)
    last = torch.where(hist > 0, idx, -1).amax(dim=1, keepdim=True)
    step = (hist.sum(1) - torch.where(idx == last, hist, 0).amax(1)) // 255
    safe = torch.clamp(step, min=1)[:, None]
    lut = torch.clamp(F.pad((torch.cumsum(hist, 1) + safe // 2) // safe, (1, 0))[:, :-1], 0, 255)
    eq = torch.gather(lut, 1, v).float().reshape(B, C, H, W).permute(0, 2, 3, 1) / 255.0
    return torch.where((step > 0).reshape(B, 1, 1, C), eq, x)


def trivial_augment(images: Tensor, ta: tuple) -> Tensor:
    op, mag_idx, sign = ta
    mag01 = mag_idx.float() / (NUM_MAGNITUDES - 1)
    signed = mag01 * sign.float()
    out = warp(images, op, signed)
    sel = lambda k: (op == k)[:, None, None, None]
    factor = (1.0 + signed * 0.99)[:, None, None, None]
    gray = _gray(out)
    mean_gray = torch.round(gray * 255.0).mean(dim=(1, 2, 3), keepdim=True) / 255.0
    shift = torch.round(mag01 * 6.0).int()
    mask = ((torch.full_like(shift, 0xFF) >> shift) << shift)[:, None, None, None]
    lo, hi = out.amin(dim=(1, 2), keepdim=True), out.amax(dim=(1, 2), keepdim=True)
    auto = torch.where(hi > lo, torch.clamp((out - lo) * torch.where(hi > lo, 1.0 / (hi - lo), 1.0),
                                            0.0, 1.0), out)
    thresh = ((1.0 - mag01) * 255.0)[:, None, None, None] / 255.0
    for k, res in ((BRIGHTNESS, _blend(out, torch.zeros_like(out), factor)),
                   (COLOR, _blend(out, gray.expand_as(out), factor)),
                   (CONTRAST, _blend(out, mean_gray * torch.ones_like(out), factor)),
                   (POSTERIZE, (torch.round(out * 255.0).int() & mask).float() / 255.0),
                   (SOLARIZE, torch.where(out >= thresh, 1.0 - out, out)),
                   (AUTOCONTRAST, auto)):
        out = torch.where(sel(k), res, out)
    out = torch.where(sel(SHARPNESS), _blend(out, _sharp_blur(out), factor), out)
    return torch.where(sel(EQUALIZE), _equalize(out), out)


# -- RandomErasing and CutMix⊕MixUp ------------------------------------------

def random_erasing(images: Tensor, erase: tuple) -> Tensor:
    apply, area, log_ratio, top_u, left_u, noise = erase
    N, H, W, _ = images.shape
    aspect = torch.exp(log_ratio)
    h = torch.clamp(torch.sqrt(area * aspect).int(), max=H)
    w = torch.clamp(torch.sqrt(area / aspect).int(), max=W)
    top = (top_u * (H - h + 1)).int()[:, None, None]
    left = (left_u * (W - w + 1)).int()[:, None, None]
    rows = torch.arange(H, device=images.device)[None, :, None]
    cols = torch.arange(W, device=images.device)[None, None, :]
    box = (rows >= top) & (rows < top + h[:, None, None]) & (cols >= left) & \
        (cols < left + w[:, None, None])
    return torch.where((apply[:, None, None] & box)[..., None], noise, images)


def mix(images: Tensor, targets: Tensor, mix_draws: tuple) -> tuple[Tensor, Tensor]:
    use_cutmix, lam, rx, ry = mix_draws
    rolled_i, rolled_t = images.roll(1, 0), targets.roll(1, 0)
    if not use_cutmix:
        return images * lam + rolled_i * (1.0 - lam), targets * lam + rolled_t * (1.0 - lam)
    _, H, W, _ = images.shape
    r = np.float32(0.5) * np.sqrt(np.float32(1.0) - np.float32(lam))
    wh, hh = int(np.floor(r * np.float32(W))), int(np.floor(r * np.float32(H)))
    x1, y1 = min(max(rx - wh, 0), W), min(max(ry - hh, 0), H)
    x2, y2 = min(max(rx + wh, 0), W), min(max(ry + hh, 0), H)
    images = images.clone()
    images[:, y1:y2, x1:x2] = rolled_i[:, y1:y2, x1:x2]
    keep = 1.0 - (x2 - x1) * (y2 - y1) / (W * H)
    return images, targets * keep + rolled_t * (1.0 - keep)


def pipeline(store: Tensor, labels: Tensor, idx: Tensor, d: Draws, crop: int,
             num_classes: int) -> tuple[Tensor, Tensor]:
    """uint8 store rows → augmented f32 images and soft targets."""
    x = store.index_select(0, idx.long()).float() / 255.0
    x = crop_resize_flip(x, d.crop, crop)
    x = trivial_augment(x, d.ta)
    if d.erase is not None:
        x = random_erasing(x, d.erase)
    t = F.one_hot(labels.index_select(0, idx.long()).long(), num_classes).float()
    return mix(x, t, d.mix)
