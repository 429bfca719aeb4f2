"""JAX package variables → the port's state dict.

Input: ``variables["params"]`` (and ``variables["batch_stats"]``) of a
``vision_toolbox_tpu`` model as nested dicts of numpy arrays (the caller
converts the flax tree; nothing here imports JAX). Output: a ``state_dict``
for the port's module of the same name, with each layout fixed once here:

- ``<dense>/kernel`` (in, out) → ``<dense>.weight`` (out, in);
- ``<conv>/kernel`` HWIO → ``<conv>.weight`` OIHW;
- LayerNorm and BatchNorm ``scale`` → ``weight``;
- BatchNorm statistics ``mean`` → ``running_mean``, ``var`` → ``running_var``;
- ``block_<i>`` → ``blocks.<i>``;
- everything else (``bias``, ``pe``, ``cls_token``, DeiT's ``dist_token``,
  ``gamma``, ``probe``, ``stem``, ``stage_<i>``, ``conv1``/``conv2``/
  ``out_conv``, ``norm``, ``head``, ``backbone``) keeps its name and layout.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^block_(\d+)$")
_RENAMED = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


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
