"""Seeded checkpoints in the official release layouts, written with torch
and numpy only (no JAX): the AugReg ViT ``.npz`` (the vision_transformer
repo's names), FB DeiT and CaiT and MS Swin and FB ConvNeXt ``.pth``, at the
published widths and depths, under the file names of the official releases
(the port's ``models/pretrained.py`` tables). Planted into a download cache
(``VTT_CACHE_DIR``), ``load_pretrained`` reads them without a download.

Weights are N(0, 0.02²), as these families initialise them; LayerNorm
scales 1 + N(0, 0.02²); LayerScale γs 0.1·(1 + U(0, 1)), since at their
1e-6 init every branch rounds away in bf16; CaiT's (H, H) head mixes
U(−1/√H, 1/√H), torch's default for their Linear.

    python tests/official_ckpts.py DIR NAME ...   # writes each file into DIR
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vision_toolbox_tpu_torch.models.pretrained import (  # noqa: E402
    AUGREG_CKPTS, CAIT_CKPTS, CONVNEXT_CKPTS, DEIT_CKPTS, SWIN_CKPTS,
)


class _Draw:
    """Seeded draws in the layouts the files store."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def w(self, *shape) -> np.ndarray:
        return self.rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def ln(self, d: int) -> tuple[np.ndarray, np.ndarray]:
        return 1 + self.w(d), self.w(d)

    def gamma(self, d: int) -> np.ndarray:
        return (0.1 * (1 + self.rng.random(d))).astype(np.float32)

    def mix(self, h: int) -> np.ndarray:
        return self.rng.uniform(-h ** -0.5, h ** -0.5, (h, h)).astype(np.float32)


def _save_pth(sd: dict, path: Path, prefix: str = "") -> None:
    torch.save({"model": {prefix + k: torch.from_numpy(v) for k, v in sd.items()}}, path)


def _vit_block(r: _Draw, sd: dict, p: str, d: int, layer_scale: bool = False,
               talking_heads: int = 0) -> None:
    """timm's ``Block`` (DeiT, CaiT's self-attention blocks, Swin's)."""
    sd[f"{p}.norm1.weight"], sd[f"{p}.norm1.bias"] = r.ln(d)
    sd[f"{p}.attn.qkv.weight"], sd[f"{p}.attn.qkv.bias"] = r.w(3 * d, d), r.w(3 * d)
    sd[f"{p}.attn.proj.weight"], sd[f"{p}.attn.proj.bias"] = r.w(d, d), r.w(d)
    if talking_heads:
        h = talking_heads
        sd[f"{p}.attn.proj_l.weight"], sd[f"{p}.attn.proj_l.bias"] = r.mix(h), r.w(h)
        sd[f"{p}.attn.proj_w.weight"], sd[f"{p}.attn.proj_w.bias"] = r.mix(h), r.w(h)
    sd[f"{p}.norm2.weight"], sd[f"{p}.norm2.bias"] = r.ln(d)
    sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = r.w(4 * d, d), r.w(4 * d)
    sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = r.w(d, 4 * d), r.w(d)
    if layer_scale:
        sd[f"{p}.gamma_1"], sd[f"{p}.gamma_2"] = r.gamma(d), r.gamma(d)


def augreg_vit(r: _Draw, path: Path, d: int, depth: int, heads: int, patch: int = 16,
               img: int = 224) -> None:
    """The AugReg ``.npz`` (flax names, packed (d, heads, d/heads) q/k/v)."""
    n, hd = (img // patch) ** 2, d // heads
    w = {"cls": r.w(1, 1, d), "Transformer/posembed_input/pos_embedding": r.w(1, n + 1, d),
         "embedding/kernel": r.w(patch, patch, 3, d), "embedding/bias": r.w(d)}
    w["Transformer/encoder_norm/scale"], w["Transformer/encoder_norm/bias"] = r.ln(d)
    for i in range(depth):
        p = f"Transformer/encoderblock_{i}"
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            w[f"{p}/{ln}/scale"], w[f"{p}/{ln}/bias"] = r.ln(d)
        a = f"{p}/MultiHeadDotProductAttention_1"
        for nm in ("query", "key", "value"):
            w[f"{a}/{nm}/kernel"], w[f"{a}/{nm}/bias"] = r.w(d, heads, hd), r.w(heads, hd)
        w[f"{a}/out/kernel"], w[f"{a}/out/bias"] = r.w(heads, hd, d), r.w(d)
        w[f"{p}/MlpBlock_3/Dense_0/kernel"], w[f"{p}/MlpBlock_3/Dense_0/bias"] = (
            r.w(d, 4 * d), r.w(4 * d))
        w[f"{p}/MlpBlock_3/Dense_1/kernel"], w[f"{p}/MlpBlock_3/Dense_1/bias"] = (
            r.w(4 * d, d), r.w(d))
    np.savez(path, **w)


def deit(r: _Draw, path: Path, d: int, depth: int, patch: int = 16, img: int = 224) -> None:
    """FB's distilled DeiT ``.pth``: ``{"model": ...}``, a PE over (cls,
    dist, patches) and both heads."""
    n = (img // patch) ** 2
    sd = {"patch_embed.proj.weight": r.w(d, 3, patch, patch), "patch_embed.proj.bias": r.w(d),
          "pos_embed": r.w(1, 2 + n, d), "cls_token": r.w(1, 1, d), "dist_token": r.w(1, 1, d),
          "head.weight": r.w(1000, d), "head.bias": r.w(1000),
          "head_dist.weight": r.w(1000, d), "head_dist.bias": r.w(1000)}
    sd["norm.weight"], sd["norm.bias"] = r.ln(d)
    for i in range(depth):
        _vit_block(r, sd, f"blocks.{i}", d)
    _save_pth(sd, path)


def cait(r: _Draw, path: Path, d: int, sa_depth: int, heads: int, patch: int = 16,
         img: int = 224) -> None:
    """FB's CaiT ``.pth``: keys under ``module.``, talking-head mixes as
    (H, H) Linear weights, class-attention blocks ``blocks_token_only``."""
    n = (img // patch) ** 2
    sd = {"patch_embed.proj.weight": r.w(d, 3, patch, patch), "patch_embed.proj.bias": r.w(d),
          "pos_embed": r.w(1, n, d), "cls_token": r.w(1, 1, d),
          "head.weight": r.w(1000, d), "head.bias": r.w(1000)}
    sd["norm.weight"], sd["norm.bias"] = r.ln(d)
    for i in range(sa_depth):
        _vit_block(r, sd, f"blocks.{i}", d, layer_scale=True, talking_heads=heads)
    for i in range(2):
        p = f"blocks_token_only.{i}"
        for proj in ("q", "k", "v", "proj"):
            sd[f"{p}.attn.{proj}.weight"], sd[f"{p}.attn.{proj}.bias"] = r.w(d, d), r.w(d)
        sd[f"{p}.norm1.weight"], sd[f"{p}.norm1.bias"] = r.ln(d)
        sd[f"{p}.norm2.weight"], sd[f"{p}.norm2.bias"] = r.ln(d)
        sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = r.w(4 * d, d), r.w(4 * d)
        sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = r.w(d, 4 * d), r.w(d)
        sd[f"{p}.gamma_1"], sd[f"{p}.gamma_2"] = r.gamma(d), r.gamma(d)
    _save_pth(sd, path, prefix="module.")


def swin(r: _Draw, path: Path, d_model: int, n_heads: int, depths: tuple[int, ...],
         window: int = 7) -> None:
    """MS Swin ``.pth``: relative-position tables ((2w − 1)², H) with their
    int64 index, patch merging's reduction in the (p1, p2, p3, p4) order."""
    dd = d_model * 2 ** (len(depths) - 1)
    sd = {"patch_embed.proj.weight": r.w(d_model, 3, 4, 4), "patch_embed.proj.bias": r.w(d_model),
          "head.weight": r.w(1000, dd), "head.bias": r.w(1000)}
    sd["patch_embed.norm.weight"], sd["patch_embed.norm.bias"] = r.ln(d_model)
    sd["norm.weight"], sd["norm.bias"] = r.ln(dd)
    index = np.zeros((window ** 2, window ** 2), np.int64)
    for s, depth in enumerate(depths):
        d, h = d_model * 2 ** s, n_heads * 2 ** s
        if s > 0:
            p = f"layers.{s - 1}.downsample"
            sd[f"{p}.norm.weight"], sd[f"{p}.norm.bias"] = r.ln(2 * d)
            sd[f"{p}.reduction.weight"] = r.w(d, 2 * d)
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}"
            _vit_block(r, sd, p, d)
            sd[f"{p}.attn.relative_position_bias_table"] = r.w((2 * window - 1) ** 2, h)
            sd[f"{p}.attn.relative_position_index"] = index
    _save_pth(sd, path)


def convnext(r: _Draw, path: Path, d_model: int, depths: tuple[int, ...]) -> None:
    """FB ConvNeXt v1 ``.pth``: ``downsample_layers``, depthwise (C, 1, 7, 7)
    kernels, ``pwconv1/2`` Linears, γ per block, the head norm."""
    dd = d_model * 2 ** (len(depths) - 1)
    sd = {"downsample_layers.0.0.weight": r.w(d_model, 3, 4, 4),
          "downsample_layers.0.0.bias": r.w(d_model),
          "head.weight": r.w(1000, dd), "head.bias": r.w(1000)}
    sd["downsample_layers.0.1.weight"], sd["downsample_layers.0.1.bias"] = r.ln(d_model)
    sd["norm.weight"], sd["norm.bias"] = r.ln(dd)
    for s, depth in enumerate(depths):
        d = d_model * 2 ** s
        if s > 0:
            p = f"downsample_layers.{s}"
            sd[f"{p}.0.weight"], sd[f"{p}.0.bias"] = r.ln(d // 2)
            sd[f"{p}.1.weight"], sd[f"{p}.1.bias"] = r.w(d, d // 2, 2, 2), r.w(d)
        for b in range(depth):
            p = f"stages.{s}.{b}"
            sd[f"{p}.dwconv.weight"], sd[f"{p}.dwconv.bias"] = r.w(d, 1, 7, 7), r.w(d)
            sd[f"{p}.norm.weight"], sd[f"{p}.norm.bias"] = r.ln(d)
            sd[f"{p}.pwconv1.weight"], sd[f"{p}.pwconv1.bias"] = r.w(4 * d, d), r.w(4 * d)
            sd[f"{p}.pwconv2.weight"], sd[f"{p}.pwconv2.bias"] = r.w(d, 4 * d), r.w(d)
            sd[f"{p}.gamma"] = r.gamma(d)
    _save_pth(sd, path)


# name -> (file name of the official release, writer, its arguments)
OFFICIAL = {
    "vit_b_16": (AUGREG_CKPTS["vit_b_16"], augreg_vit, (768, 12, 12)),
    "deit_ti_16": (DEIT_CKPTS[("deit_ti_16", 224)], deit, (192, 12)),
    "deit_b_16": (DEIT_CKPTS[("deit_b_16", 224)], deit, (768, 12)),
    "cait_s_24": (CAIT_CKPTS[("cait_s_24", 224)], cait, (384, 24, 8)),
    "swin_t": (SWIN_CKPTS["swin_t"], swin, (96, 3, (2, 2, 6, 2))),
    "convnext_t": (CONVNEXT_CKPTS["convnext_t"], convnext, (96, (3, 3, 9, 3))),
}


def write(name: str, cache: str | os.PathLike, seed: int = 0) -> Path:
    """Write ``name``'s official file into ``cache`` under the basename
    ``load_pretrained`` looks for; returns its path."""
    fname, writer, args = OFFICIAL[name]
    path = Path(cache) / os.path.basename(fname)
    writer(_Draw(seed), path, *args)
    return path


if __name__ == "__main__":
    for n in sys.argv[2:]:
        print(write(n, sys.argv[1]))
