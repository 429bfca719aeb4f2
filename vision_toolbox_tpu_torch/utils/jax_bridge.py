"""JAX package variables → the port's state dict.

Input: ``variables["params"]`` (and ``variables["batch_stats"]``) of a
``vision_toolbox_tpu`` model as nested dicts of numpy arrays (the caller
converts the flax tree; nothing here imports JAX). Output: a ``state_dict``
for the port's module of the same name, with each layout fixed once here:

- ``<dense>/kernel`` (in, out) → ``<dense>.weight`` (out, in);
- ``<conv>/kernel`` HWIO → ``<conv>.weight`` OIHW;
- LayerNorm and BatchNorm ``scale`` → ``weight``;
- BatchNorm statistics ``mean`` → ``running_mean``, ``var`` → ``running_var``;
- ``block_<i>`` → ``blocks.<i>`` (the Mixer's and PatchConvNet's too),
  CaiT's ``sa_block_<i>`` → ``sa_blocks.<i>`` and ``ca_block_<i>`` →
  ``ca_blocks.<i>``, ConvNeXt's, Swin's and VoVNet's
  ``stage_<i>_block_<j>`` → ``stages.<i>.<j>``;
- everything else (``bias``, ``pe``, ``cls_token``, DeiT's ``dist_token``,
  ``gamma``, ``probe``, ``stem``, ``stage_<i>``, ``conv1``/``conv2``/
  ``out_conv``, ``norm``, ``head``, ``backbone``, ConvNeXt's ``stem_conv``,
  ``stem_norm``, ``downsample_{norm,conv}_<i>``, ``dwconv`` (its (k, k, 1, C)
  kernel by the HWIO rule), ``pwconv1/2``, ``layer_scale`` and ``grn``'s
  ``gamma``/``beta``, Swin's ``patch_embed``, ``patch_norm``,
  ``downsample_<i>/{norm,reduction}``, ``mha/{q,k,v,out}_proj`` and
  ``relative_pe_table`` (its (1, heads, (2w − 1)²) layout), and CaiT's (H, H) head
  mixes ``proj_l_kernel``/``proj_w_kernel`` with their biases, which are no
  Dense kernels: ``mix[g, h]`` on both sides) keeps its name and layout.

The Mixer, PatchConvNet and VoVNet need no rule of their own:
- the Mixer's ``patch_embed`` (a conv kernel), ``norm1``/``norm2``/``norm``
  and the ``token_mixing``/``channel_mixing`` linears;
- PatchConvNet's ``stem_<i>`` conv kernels, each block's ``norm`` (flax's
  BatchNorm with its ``mean``/``var``, or a LayerNorm), ``mix1``/``mix2``
  Dense kernels, ``dwconv`` (3, 3, 1, C) kernel, ``se/fc1``, ``se/fc2`` 1×1
  conv kernels and ``layer_scale``; the head ``pool`` with ``cls_token``,
  ``norm1``–``norm3``, ``{q,k,v,out}_proj``, ``layer_scale_1``/``_2`` and
  ``mlp``;
- VoVNet's ``stem_<i>``, ``conv_<i>`` and ``out_conv`` (each a ``conv``
  kernel and a BatchNorm ``norm``) and ``ese/linear`` (a 1×1 conv kernel
  with its bias).

The MBConv nets, ResNets, RegNets and necks need none either:
- EfficientNet's and RegNet's ``stage_<i>_block_<j>`` and MobileNetV3's
  ``block_<i>`` take the rules above; their ``stem``, ``last_conv``,
  ``expand``, ``dwconv`` (a depthwise conv kernel by the HWIO rule),
  ``project``, ``conv1``–``conv3``, ``downsample`` and ``se/fc1``,
  ``se/fc2`` keep their names;
- ResNet's ``layer<i>_block<j>`` keep theirs: the port's blocks are
  attributes of that name, so no rule maps them;
- the necks' ``lateral_<i>`` (BiFPN's a conv kernel with its bias, FPN's a
  ``conv`` under it), ``out_conv_<i>``, ``top_down``, ``bottom_up``,
  ``layer_<i>``, ``td_fuse_<i>``, ``out_fuse_<i>``, ``last_out_fuse``, the
  fusions' ``weights`` vector and their ``conv`` block (``dw``/``pw``);
- ``DeformableConv2d``'s ``conv_offset``, ``conv_mask`` and its raw
  (k, k, C, Co) ``kernel``, which the HWIO rule turns into the port's
  (Co, C, k, k) ``weight``.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^((?:sa_|ca_)?block)_(\d+)$")
_STAGE_BLOCK = re.compile(r"^stage_(\d+)_block_(\d+)$")
_RENAMED = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _convert(path: tuple[str, ...], value: np.ndarray) -> tuple[str, np.ndarray]:
    parts = [f"{m.group(1)}s.{m.group(2)}" if (m := _BLOCK.match(p))
             else f"stages.{m.group(1)}.{m.group(2)}" if (m := _STAGE_BLOCK.match(p)) else p
             for p in path]
    leaf = parts[-1]
    if leaf == "kernel":
        parts[-1] = "weight"
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank {value.ndim} at {'/'.join(path)}")
    elif leaf in _RENAMED:
        parts[-1] = _RENAMED[leaf]
    return ".".join(parts), value


def flax_to_state_dict(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any] | None = None) -> dict[str, torch.Tensor]:
    """Map a JAX-package param tree and its BatchNorm statistics (numpy
    leaves) to a port state dict."""
    out = {}
    for tree in (params, batch_stats or {}):
        for path, value in _flatten(tree):
            name, value = _convert(path, value)
            out[name] = torch.tensor(value, dtype=torch.float32)
    return out
