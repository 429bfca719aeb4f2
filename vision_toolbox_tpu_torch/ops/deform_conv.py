"""Deformable convolution v1/v2 — port of
``vision_toolbox_tpu/ops/deform_conv.py``.

One bilinear gather and one product with the tap's weights per kernel tap
(k² taps), all batched, zero outside the map. The offset layout is
torchvision's: channel 2·(ky·k + kx) is Δy, the next Δx. No Pallas kernel
computes this in the JAX package (XLA runs its gathers and products), so
plain PyTorch is its port, as ``torch.matmul`` is for the products XLA
computes; the sample, the mask, the per-tap product and the sum follow the
JAX function's order and types. NHWC tensors; ``weight`` is (out, in, k, k),
the bridge's layout of the JAX function's (k, k, in, out).
"""

from __future__ import annotations

import torch
from torch import Tensor


def _bilinear_sample(x: Tensor, sy: Tensor, sx: Tensor) -> Tensor:
    """x (B, H, W, C) sampled at float coordinates sy, sx (B, Ho, Wo), zero
    outside the map."""
    B, H, W, C = x.shape
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    flat = x.reshape(B, H * W, C)

    def gather(yi: Tensor, xi: Tensor) -> Tensor:
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        vals = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        return vals.reshape(*yi.shape, C) * valid[..., None].to(x.dtype)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def deform_conv2d(x: Tensor, weight: Tensor, offset: Tensor, mask: Tensor | None = None,
                  bias: Tensor | None = None, stride: int = 1, padding: int = 0,
                  dilation: int = 1) -> Tensor:
    """x (B, H, W, C), weight (Co, C, k, k), offset (B, Ho, Wo, 2k²), mask
    (B, Ho, Wo, k²) or None, bias (Co,) or None → (B, Ho, Wo, Co): the taps
    in ky, kx order, each sampled, masked and multiplied by ``weight[..., ky,
    kx]``, summed, then the bias."""
    B, H, W, C = x.shape
    k = weight.shape[-1]
    Ho = (H + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    if tuple(offset.shape[:3]) != (B, Ho, Wo) or offset.shape[-1] != 2 * k * k:
        raise ValueError(f"deform_conv2d: offset {tuple(offset.shape)} must be "
                         f"{(B, Ho, Wo, 2 * k * k)} for x {tuple(x.shape)} and k = {k}")
    base_y = (torch.arange(Ho, dtype=torch.float32, device=x.device) * stride - padding)[:, None]
    base_x = (torch.arange(Wo, dtype=torch.float32, device=x.device) * stride - padding)[None, :]
    out = None
    for ky in range(k):
        for kx in range(k):
            tap = ky * k + kx
            sy = base_y + ky * dilation + offset[..., 2 * tap]
            sx = base_x + kx * dilation + offset[..., 2 * tap + 1]
            sampled = _bilinear_sample(x, sy, sx)
            if mask is not None:
                sampled = sampled * mask[..., tap, None]
            w = weight[:, :, ky, kx]
            dt = torch.promote_types(sampled.dtype, w.dtype)
            term = torch.einsum("bhwc,oc->bhwo", sampled.to(dt), w.to(dt))
            out = term if out is None else out + term
    return out if bias is None else out + bias
