"""Batch augmentation on the device — port of
``vision_toolbox_tpu/ops/augment.py``: one-hot labels, MixUp, CutMix, the
per-batch CutMix⊕MixUp coin, and RandomErasing.

Each op is split into *draws* (``sample_*``, from an explicit
``torch.Generator``) and *apply given draws*, so the tests can feed the JAX
package's draws to the port. Semantics: pairing by ``roll(1, dim=0)`` (of
the global batch inside a sharded step, ``parallel/mesh.rolled_rows``); one
Beta(α, α) λ per batch; the CutMix box has a uniform centre and half-size
``0.5·√(1−λ)``, is clamped to the image, and λ is recomputed from the box's
area; RandomErasing draws one box per image and fills it with N(0, 1) noise.

Per-batch scalars (coin, λ, box centre) are drawn on the host: PyTorch's
Beta and Gamma samplers take no generator, so a numpy ``Generator`` seeded
from the step's generator draws them (on a CUDA generator that seed is one
device-to-host read per step, counted in ``tracing``'s ``host_syncs``).
Images are NHWC; labels are int class ids or already-one-hot float arrays.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from ..parallel.mesh import active_data_axis, rolled_rows
from ..utils import tracing


def one_hot_labels(labels: Tensor, num_classes: int, dtype: torch.dtype = torch.float32) -> Tensor:
    if labels.ndim == 1:
        return F.one_hot(labels.long(), num_classes).to(dtype)
    return labels.to(dtype)


def host_rng(generator: torch.Generator) -> np.random.Generator:
    """A numpy generator seeded from ``generator`` (one draw from it; on a
    CUDA generator the host waits for the device to read it: a ``sync``)."""
    seed = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
    return np.random.default_rng(int(tracing.to_host(seed)[0]))


class MixDraws(NamedTuple):
    """Per-batch draws of CutMix⊕MixUp: which op, λ ~ Beta(α, α) of that op,
    and the CutMix box centre (column, row)."""

    use_cutmix: bool
    lam: float
    r_x: int = 0
    r_y: int = 0


def sample_mix(rng: np.random.Generator, height: int, width: int, cutmix_alpha: float = 1.0,
               mixup_alpha: float = 0.2) -> MixDraws:
    if cutmix_alpha <= 0 and mixup_alpha <= 0:
        raise ValueError("one of cutmix_alpha / mixup_alpha must be > 0")
    if cutmix_alpha <= 0:
        use_cutmix = False
    elif mixup_alpha <= 0:
        use_cutmix = True
    else:
        use_cutmix = bool(rng.random() < 0.5)
    if not use_cutmix:
        return MixDraws(False, float(rng.beta(mixup_alpha, mixup_alpha)))
    lam = float(rng.beta(cutmix_alpha, cutmix_alpha))
    return MixDraws(True, lam, int(rng.integers(0, width)), int(rng.integers(0, height)))


def _roll(t: Tensor) -> Tensor:
    """Each row's partner: ``roll(1, 0)`` of the (global) batch."""
    return rolled_rows(t, active_data_axis())


def mixup(images: Tensor, targets: Tensor, lam: float) -> tuple[Tensor, Tensor]:
    """Batch MixUp with the given λ. λ is rounded to the images' dtype first
    and used so rounded for the targets too, as in the JAX package."""
    lam_i = torch.tensor(lam, dtype=torch.float32).to(images.dtype)  # 0-d: 1 − λ rounds as images
    lam_t = lam_i.to(targets.dtype)
    images = images * lam_i.to(images.device) + _roll(images) * (1.0 - lam_i).to(images.device)
    targets = targets * lam_t.item() + _roll(targets) * (1.0 - lam_t).item()
    return images, targets


def cutmix_box(height: int, width: int, lam: float, r_x: int, r_y: int) -> tuple[int, int, int, int]:
    """(x1, y1, x2, y2) of the CutMix box, clamped to the image (f32 maths)."""
    r = np.float32(0.5) * np.sqrt(np.float32(1.0) - np.float32(lam))
    w_half = int(np.floor(r * np.float32(width)))
    h_half = int(np.floor(r * np.float32(height)))
    clip = lambda v, hi: min(max(v, 0), hi)
    return (clip(r_x - w_half, width), clip(r_y - h_half, height),
            clip(r_x + w_half, width), clip(r_y + h_half, height))


def cutmix(images: Tensor, targets: Tensor, lam: float, r_x: int, r_y: int) -> tuple[Tensor, Tensor]:
    """Batch CutMix: one box per batch pasted from the rolled batch; the
    targets mix by the box's actual area."""
    _, H, W, _ = images.shape
    x1, y1, x2, y2 = cutmix_box(H, W, lam, r_x, r_y)
    images = images.clone()
    images[:, y1:y2, x1:x2] = _roll(images)[:, y1:y2, x1:x2]
    area = np.float32((x2 - x1) * (y2 - y1)) / np.float32(W * H)
    lam_adj = torch.tensor(np.float32(1.0) - area).to(targets.dtype)
    targets = targets * lam_adj.item() + _roll(targets) * (1.0 - lam_adj).item()
    return images, targets


def cutmix_mixup(images: Tensor, targets: Tensor, draws: MixDraws) -> tuple[Tensor, Tensor]:
    """CutMix or MixUp, as the per-batch coin in ``draws`` says."""
    if draws.use_cutmix:
        return cutmix(images, targets, draws.lam, draws.r_x, draws.r_y)
    return mixup(images, targets, draws.lam)


class EraseDraws(NamedTuple):
    """Per-image draws of RandomErasing: apply (N,) bool, box area in pixels
    (N,), log aspect ratio (N,), uniforms for top and left (N,), and the
    N(0, 1) fill (N, H, W, C)."""

    apply: Tensor
    area: Tensor
    log_ratio: Tensor
    top_u: Tensor
    left_u: Tensor
    noise: Tensor


def sample_random_erasing(
    generator: torch.Generator, shape: tuple[int, int, int, int], p: float = 0.1,
    scale: tuple[float, float] = (0.02, 0.33), ratio: tuple[float, float] = (0.3, 3.3),
) -> EraseDraws:
    N, H, W, C = shape
    dev = generator.device
    u = lambda lo, hi: lo + torch.rand((N,), generator=generator, device=dev) * (hi - lo)
    return EraseDraws(
        apply=torch.rand((N,), generator=generator, device=dev) < p,
        area=u(scale[0], scale[1]) * (H * W),
        log_ratio=u(math.log(ratio[0]), math.log(ratio[1])),
        top_u=torch.rand((N,), generator=generator, device=dev),
        left_u=torch.rand((N,), generator=generator, device=dev),
        noise=torch.randn(shape, generator=generator, device=dev),
    )


def random_erasing(images: Tensor, draws: EraseDraws) -> Tensor:
    """Per-image RandomErasing (value="random") given the draws: one box,
    clamped to the image, filled with the noise."""
    N, H, W, C = images.shape
    dev = images.device
    area, aspect = draws.area.to(dev), torch.exp(draws.log_ratio.to(dev))
    h = torch.clamp(torch.sqrt(area * aspect).to(torch.int32), max=H)
    w = torch.clamp(torch.sqrt(area / aspect).to(torch.int32), max=W)
    top = (draws.top_u.to(dev) * (H - h + 1)).to(torch.int32)
    left = (draws.left_u.to(dev) * (W - w + 1)).to(torch.int32)
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    t, l = top[:, None, None], left[:, None, None]
    box = (rows >= t) & (rows < t + h[:, None, None]) & (cols >= l) & (cols < l + w[:, None, None])
    erase = (draws.apply.to(dev)[:, None, None] & box)[..., None]
    return torch.where(erase, draws.noise.to(dev, images.dtype), images)
