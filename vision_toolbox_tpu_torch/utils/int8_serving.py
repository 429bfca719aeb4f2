"""Weight-int8 and dynamic-activation-int8 serving — port of
``vision_toolbox_tpu/utils/int8_serving.py``.

``quantize_model`` returns a copy of a model in which every ``Linear`` whose
weight has at least ``min_size`` elements (the JAX rule: a 2-D kernel of
that size) is an ``Int8Linear``: per-output-channel symmetric int8 weights
(absmax / 127) and, at run time, per-row absmax int8 activations, an exact
int32 product (``torch._int_mm``), the rescale and the bias in f32, the
result in the module's compute type. Convolutions, CaiT's head mixes and
every other parameter stay as they are; the original model is untouched.
A fused half-block whose projections are quantized takes its module chain
(``nn/attention.float_linears``), so that every eligible projection runs
int8: on the card a quantized ViT's attention then runs the short-attention
kernel K2 (``ops/short_attention.py``) from batch 6 of vit_b_16. The served
artifact is the exported program:

    blob = export_model(quantize_model(model), (8, 224, 224, 3))
    served = load_exported(blob)
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import Tensor, nn
from torch.fx.experimental.symbolic_shapes import statically_known_true

from ..nn.layers import Linear


def _absmax_scale(t: Tensor, dim: int) -> Tensor:
    """absmax of ``t`` along ``dim`` / 127, floored at 1e-12 (kept dim).
    The divisor is a tensor: CUDA would multiply by the reciprocal of a
    Python scalar, one ulp off the exact quotient that the CPU computes."""
    m = t.abs().amax(dim, keepdim=True)
    return torch.clamp(m / m.new_full((), 127.0), min=1e-12)


def _quantize(t: Tensor, scale: Tensor) -> Tensor:
    """round(t / scale) (half to even), clipped to ±127, as int8."""
    return torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)


def int8_matmul(x8: Tensor, w8: Tensor) -> Tensor:
    """x8 (M, K) int8 · w8ᵀ, w8 (N, K) int8 → (M, N) int32, exact.
    ``torch._int_mm`` on CUDA takes more than 16 rows and K and N multiples
    of 8: the operands are padded with zeros to that, which adds nothing to
    any sum, and the result is cut back."""
    M, K = x8.shape
    N = w8.shape[0]
    pk, pn = -K % 8, -N % 8
    pad_rows = not statically_known_true(M > 16)  # a served batch stays free
    if pk or pad_rows:
        x8 = F.pad(x8, (0, pk, 0, torch.sym_max(17 - M, 0) if pad_rows else 0))
    if pk or pn:
        w8 = F.pad(w8, (0, pk, 0, pn))
    out = torch._int_mm(x8, w8.t())
    return out[:M, :N] if pad_rows or pn else out


class Int8Linear(nn.Module):
    """A ``Linear`` served in int8: ``w8`` (out, in) int8, ``scale`` (out,)
    f32, ``bias`` (out,) f32 or None, all buffers; ``dtype`` the Linear's
    compute type (None: the input's)."""

    def __init__(self, linear: Linear):
        super().__init__()
        w = linear.weight.detach().float()
        scale = _absmax_scale(w, 1)
        self.register_buffer("w8", _quantize(w, scale))
        self.register_buffer("scale", scale[:, 0])
        self.register_buffer("bias", None if linear.bias is None else linear.bias.detach().float())
        self.dtype = linear.dtype

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        xs = _absmax_scale(xf, -1)
        acc = int8_matmul(_quantize(xf, xs).reshape(-1, x.shape[-1]), self.w8)
        y = acc.reshape(*x.shape[:-1], -1).float() * xs * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype or x.dtype)


def quantize_model(model: nn.Module, min_size: int = 4096) -> nn.Module:
    """A copy of ``model`` with every ``Linear`` of at least ``min_size``
    weight elements replaced by its ``Int8Linear``; ``model`` is untouched."""
    model = copy.deepcopy(model)
    for parent in list(model.modules()):
        for name, child in parent.named_children():
            if isinstance(child, Linear) and child.weight.numel() >= min_size:
                setattr(parent, name, Int8Linear(child))
    return model
