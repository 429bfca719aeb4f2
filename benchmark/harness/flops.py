"""The yardstick's arithmetic: the card's published peaks, a frozen count of
a plain reference's floating-point operations, and the least time of the
fused transformer half-blocks at given shapes.

Operations are 2·M·N·K for every product (matmul and convolution),
counted from the shapes the reference's operators see; nothing else (norms,
softmax, elementwise) is counted. Bytes count each input byte read once and
each output byte written once.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA's data sheet, H100 SXM5, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name == "mm":
            (m, k), n = args[0].shape, args[1].shape[1]
            self.flops += 2 * m * n * k
        elif name == "addmm":
            (m, k), n = args[1].shape, args[2].shape[1]
            self.flops += 2 * m * n * k
        elif name in ("bmm", "baddbmm"):
            a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
            self.flops += 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        elif name == "convolution":
            w = args[1]  # (out, in / groups, kh, kw)
            self.flops += 2 * out.numel() * math.prod(w.shape[1:])
        return out


def forward_flops(model: torch.nn.Module, input_shape: tuple[int, ...]) -> int:
    """Operations of one forward of ``model`` (built on the meta device) per
    image of ``input_shape`` (counted at two images: batch statistics need
    more than one)."""
    x = torch.empty((2, *input_shape[1:]), device="meta")
    counter = _CountProducts()
    with torch.no_grad(), counter:
        model(x)
    return counter.flops // 2 * input_shape[0]


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def vit_halfblocks(batch: int, tokens: int, d: int, hidden: int) -> dict[str, tuple[int, int]]:
    """(operations, bytes) of one ViT block's two half-blocks, forward and
    backward: bf16 activations, f32 parameters and parameter gradients.
    Forward reads x and the parameters and writes the output; backward
    reads x, the parameters and the output's gradient and writes dx and the
    parameters' gradients; the backward's products are twice the
    forward's."""
    act = batch * tokens * d * 2
    attn_params = (4 * d * d + 4 * d + 2 * d) * 4
    mlp_params = (2 * d * hidden + hidden + d + 2 * d) * 4
    attn = 2 * batch * tokens * 4 * d * d + 4 * batch * tokens * tokens * d
    mlp = 4 * batch * tokens * d * hidden
    return {
        "attention.fwd": (attn, 2 * act + attn_params),
        "attention.bwd": (2 * attn, 3 * act + 2 * attn_params),
        "mlp.fwd": (mlp, 2 * act + mlp_params),
        "mlp.bwd": (2 * mlp, 3 * act + 2 * mlp_params),
    }


def vit_blocks_least_seconds(arch: dict, batch: int, train: bool) -> float:
    """Least time of all blocks of a ViT at ``batch`` images: each
    half-block bounded by the larger of its operations over the bf16 peak
    and its bytes over the HBM bandwidth."""
    tokens = (arch["image_size"] // arch["patch_size"]) ** 2 + 1
    parts = vit_halfblocks(batch, tokens, arch["hidden_size"], arch["mlp_dim"])
    keep = ("fwd", "bwd") if train else ("fwd",)
    per_block = sum(least_seconds(*v) for k, v in parts.items() if k.endswith(keep))
    return arch["num_layers"] * per_block
