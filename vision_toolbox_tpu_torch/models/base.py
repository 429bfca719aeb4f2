"""Backbone contract + registry — port of ``vision_toolbox_tpu/models/base.py``.

Every backbone exposes ``get_feature_maps(x) -> list``, ``out_channels_list``
and ``stride``; ``forward`` returns the last feature map. Its parameters are
float32 and ``compute_dtype`` is the type its forward rounds them to at use
(norm layers apart), which ``cast_for_serving`` stores them in once. Models
register a factory under a string name for ``create_backbone``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import Tensor, nn

from ..nn.layers import LayerNorm
from ..nn.norm import BatchNorm, LinenBatchNorm


class Backbone(nn.Module):
    """Abstract backbone: subclasses implement ``get_feature_maps`` only."""

    compute_dtype: torch.dtype = torch.float32

    def cast_for_serving(self) -> "Backbone":
        """In place: every parameter but the norm layers' (and those of a
        module whose ``keeps_f32_params`` is set, such as CaiT's head mixes,
        which its kernels read in f32) rounded to ``compute_dtype`` once, so
        that a served request pays no casts. The forward is unchanged (it
        rounds at use to the same values)."""
        norms = (LayerNorm, BatchNorm, LinenBatchNorm)
        for m in self.modules():
            if not isinstance(m, norms) and not getattr(m, "keeps_f32_params", False):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(self.compute_dtype)
        return self

    def get_feature_maps(self, x: Tensor, train: bool = False) -> list[Tensor]:
        raise NotImplementedError

    def forward(self, x: Tensor, train: bool = False, generator=None) -> Tensor:
        """The last feature map. ``generator`` feeds a backbone's random
        draws in training (none in the convnets)."""
        return self.get_feature_maps(x, train=train)[-1]

    @property
    def out_channels_list(self) -> tuple[int, ...]:
        raise NotImplementedError

    @property
    def stride(self) -> int:
        raise NotImplementedError

    @property
    def last_out_channels(self) -> int:
        return self.out_channels_list[-1]


def to_device(model: nn.Module, device: torch.device | str) -> None:
    """Move a freshly built model to ``device``. The models' default is the
    card ("cuda"): without one this raises instead of staying on the CPU;
    pass ``device="cpu"`` to build there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{type(model).__name__}: device {str(device)!r} asked for and no "
                           "CUDA device is available; pass device='cpu' to build on the CPU")
    model.to(device)


_REGISTRY: dict[str, Callable[..., nn.Module]] = {}


def register_model(name: str):
    def deco(fn: Callable[..., nn.Module]):
        if name in _REGISTRY:
            raise ValueError(f"duplicate model name {name}")
        _REGISTRY[name] = fn
        return fn

    return deco


def create_backbone(name: str, **kwargs: Any) -> nn.Module:
    """Build a backbone by registry name, e.g. ``create_backbone("vit_b_16")``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown backbone {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_backbones() -> list[str]:
    return sorted(_REGISTRY)
