"""Host-side image transforms — port of
``vision_toolbox_tpu/data/transforms.py`` (the same PIL and numpy code, so
the same ``random.Random`` gives bit-equal arrays). Decode-adjacent only:
everything batchable runs on the device instead (ops/augment.py,
ops/trivial_augment.py, ops/device_rrc.py).

Reference pipeline (data.py:44-59):
  train: RandomResizedCrop(176) + RandomHorizontalFlip   [host, per-sample]
         + TrivialAugmentWide + RandomErasing            [→ device batch ops]
  val:   Resize(232) + CenterCrop(224)                   [host]

Torchvision semantics reproduced: RRC samples area ∈ scale·A and log-uniform
aspect ratio with 10 attempts then falls back to a center crop; Resize scales
the short side; PIL bilinear resize is antialiased, matching torchvision's
PIL backend (the one the reference uses).
"""

from __future__ import annotations

import math
import random

import numpy as np
from PIL import Image


def random_resized_crop(
    rng: random.Random,
    img: Image.Image,
    size: int,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3 / 4, 4 / 3),
) -> Image.Image:
    W, H = img.size
    area = W * H
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            # randrange(0, n + 1) is what random.Random.randint(0, n) calls
            x = rng.randrange(0, W - w + 1)
            y = rng.randrange(0, H - h + 1)
            return img.resize((size, size), Image.BILINEAR, box=(x, y, x + w, y + h))
    # fallback: center crop at the in-range aspect ratio (torchvision behavior)
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w, h = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = H, int(round(H * ratio[1]))
    else:
        w, h = W, H
    x = (W - w) // 2
    y = (H - h) // 2
    return img.resize((size, size), Image.BILINEAR, box=(x, y, x + w, y + h))


def resize_short_side(img: Image.Image, size: int) -> Image.Image:
    W, H = img.size
    if W <= H:
        nw, nh = size, int(round(size * H / W))
    else:
        nw, nh = int(round(size * W / H)), size
    return img.resize((nw, nh), Image.BILINEAR)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    W, H = img.size
    x = (W - size) // 2
    y = (H - size) // 2
    return img.crop((x, y, x + size, y + size))


def to_float_array(img: Image.Image) -> np.ndarray:
    """HWC float32 in [0, 1] (ToTensor without the CHW permute — NHWC native)."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return arr


def train_transform(rng: random.Random, img: Image.Image, crop_size: int = 176) -> np.ndarray:
    img = random_resized_crop(rng, img, crop_size)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return to_float_array(img)


def val_transform(img: Image.Image, resize_size: int = 232, crop_size: int = 224) -> np.ndarray:
    return to_float_array(center_crop(resize_short_side(img, resize_size), crop_size))
