"""JAX package parameters → the port's state dict.

Input: ``variables["params"]`` of a ``vision_toolbox_tpu`` model as a nested
dict of numpy arrays (the caller converts the flax tree; nothing here
imports JAX). Output: a ``state_dict`` for the port's module of the same
name, with each layout fixed once here:

- ``<dense>/kernel`` (in, out) → ``<dense>.weight`` (out, in);
- ``<conv>/kernel`` HWIO → ``<conv>.weight`` OIHW (``patch_embed``);
- LayerNorm ``scale`` → ``weight``;
- ``block_<i>`` → ``blocks.<i>``;
- everything else (``bias``, ``pe``, ``cls_token``, ``gamma``, ``probe``)
  keeps its name and layout.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^block_(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _convert(path: tuple[str, ...], value: np.ndarray) -> tuple[str, np.ndarray]:
    parts = [f"blocks.{m.group(1)}" if (m := _BLOCK.match(p)) else p for p in path]
    leaf = parts[-1]
    if leaf == "kernel":
        parts[-1] = "weight"
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank {value.ndim} at {'/'.join(path)}")
    elif leaf == "scale":
        parts[-1] = "weight"
    return ".".join(parts), value


def flax_to_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map a JAX-package param tree (numpy leaves) to a port state dict."""
    out = {}
    for path, value in _flatten(params):
        name, value = _convert(path, value)
        out[name] = torch.tensor(value, dtype=torch.float32)
    return out
