"""Plain PyTorch references of the benchmark's models, from their papers:
ViT-B/16 (Dosovitskiy et al., arXiv:2010.11929, Table 1) with the recipe's
linear classifier head.

Every product (``F.linear``, ``F.conv2d``, the attention's two matmuls) runs
in float32 on the plain PyTorch operators, TF32 off (``run`` sets it), or,
for the control, with each operand rounded to float8 e4m3 (per-tensor scale,
its gradient to e5m2), the precision below the bf16 that the configurations
state. Parameters are named as the served and trained models name theirs
(``backbone.<...>``, ``head.<...>``), so that one set of weights made from
the seed loads into both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor, nn

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round_fp8(x: Tensor, dtype: torch.dtype, top: float) -> Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Precision(nn.Module):
    """A module whose products round their operands as ``self.fp8`` says."""

    fp8 = False

    def q(self, x: Tensor) -> Tensor:
        return _Fp8.apply(x) if self.fp8 else x


class Linear(Precision):
    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class Affine(nn.Module):
    """The weight and bias of a norm layer."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))


class LayerNorm(Affine):
    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-6)


class Attention(Precision):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(d, d))

    def forward(self, x: Tensor) -> Tensor:
        B, T, D = x.shape
        split = lambda t: t.reshape(B, T, self.heads, D // self.heads).transpose(1, 2)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        s = self.q(q) @ self.q(k).transpose(-1, -2) / math.sqrt(D // self.heads)
        o = self.q(torch.softmax(s, dim=-1)) @ self.q(v)
        return self.out_proj(o.transpose(1, 2).reshape(B, T, D))


class MLP(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.linear1, self.linear2 = Linear(d, hidden), Linear(hidden, d)

    def forward(self, x: Tensor) -> Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


class Block(nn.Module):
    def __init__(self, d: int, heads: int, hidden: int):
        super().__init__()
        self.mha_norm, self.mha = LayerNorm(d), Attention(d, heads)
        self.mlp_norm, self.mlp = LayerNorm(d), MLP(d, hidden)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.mha(self.mha_norm(x))
        return x + self.mlp(self.mlp_norm(x))


class PatchEmbed(Precision):
    def __init__(self, d: int, patch: int):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(d, 3, patch, patch))
        self.bias = nn.Parameter(torch.empty(d))

    def forward(self, x: Tensor) -> Tensor:
        y = F.conv2d(self.q(x.permute(0, 3, 1, 2)), self.q(self.weight), self.bias,
                     stride=self.patch)
        return y.flatten(2).transpose(1, 2)


class ViT(nn.Module):
    """Pre-LN ViT with a class token; features are the final norm of the
    class token."""

    def __init__(self, num_layers: int, hidden_size: int, mlp_dim: int, num_heads: int,
                 patch_size: int, image_size: int, **_):
        super().__init__()
        d, n = hidden_size, (image_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(d, patch_size)
        self.pe = nn.Parameter(torch.empty(1, n, d))
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.blocks = nn.ModuleList(Block(d, num_heads, mlp_dim) for _ in range(num_layers))
        self.norm = LayerNorm(d)
        self.width = d

    def forward(self, x: Tensor) -> Tensor:
        t = self.patch_embed(x) + self.pe
        t = torch.cat([self.cls_token.expand(t.shape[0], -1, -1), t], dim=1)
        for block in self.blocks:
            t = block(t)
        return self.norm(t[:, 0])


class Classifier(nn.Module):
    """The backbone and a linear head."""

    def __init__(self, backbone: nn.Module, num_classes: int):
        super().__init__()
        self.backbone = backbone
        self.head = Linear(backbone.width, num_classes)

    def forward(self, x: Tensor) -> Tensor:
        return self.head(self.backbone(x))


BUILDERS = {"vit": ViT}


def build(arch: dict, classifier: bool, device: torch.device | str = "cpu",
          fp8: bool = False) -> nn.Module:
    """The reference of ``arch`` (a configuration's ``architecture``), its
    parameters uninitialised (``weights.make`` fills them)."""
    model = BUILDERS[arch["reference"]](**arch)
    if classifier:
        model = Classifier(model, arch["num_classes"])
    for m in model.modules():
        if isinstance(m, Precision):
            m.fp8 = fp8
    return model.to(device)


def init_rule(name: str, shape: tuple[int, ...]) -> tuple[float, float]:
    """(mean, std) of the benchmark's seeded weights for a parameter: norm
    scales 1 ± 0.02, biases, position table and class token 0 ± 0.02,
    products N(0, 1/fan-in)."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 1 and leaf == "weight":
        return 1.0, 0.02
    if len(shape) == 1 or leaf in ("pe", "cls_token"):
        return 0.0, 0.02
    return 0.0, math.sqrt(1.0 / math.prod(shape[1:]))
