"""Weights and data made from the seed, on the device, in a few large calls."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..reference.models import init_rule


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one use (weights, store, requests) of the run's
    seed."""
    return int(np.random.default_rng([seed, purpose]).integers(2**63))


WEIGHTS, STORE, REQUESTS, SAMPLE = range(4)


def make(model: torch.nn.Module, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Float32 weights for every parameter of ``model`` (a reference, built
    on any device), by name: one normal draw over them all, each slice
    scaled by ``init_rule``."""
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.randn(sum(int(np.prod(s)) for _, s in shapes), generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        mean, std = init_rule(name, shape)
        out[name] = (flat[at:at + n] * std + mean).view(shape)
        at += n
    return out


def load(model: torch.nn.Module, weights: dict[str, torch.Tensor], prefix: str = "") -> None:
    """Copy ``weights`` into ``model``'s parameters of the same names (and
    shapes); every parameter has to be given."""
    params = {n: p for n, p in model.named_parameters()}
    names = {prefix + n for n in params}
    if names != set(weights):
        raise KeyError(f"weights and model disagree: {sorted(names ^ set(weights))[:8]}")
    with torch.no_grad():
        for n, p in params.items():
            w = weights[prefix + n]
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{n}: weights {tuple(w.shape)} for a parameter {tuple(p.shape)}")
            p.copy_(w)


def images(seed: int, purpose: int, n: int, size: int, device: torch.device) -> torch.Tensor:
    """(n, size, size, 3) uint8 images: smooth colour fields (8 × 8 normal
    draws, bilinear to size) with a little noise."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))
    coarse = torch.randn((n, 3, 8, 8), generator=g, device=device)
    fine = torch.randn((n, 3, size, size), generator=g, device=device)
    x = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    x = torch.sigmoid(1.5 * x + 0.3 * fine)
    return (x * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
