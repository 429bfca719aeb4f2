"""Backbone contract + registry — port of ``vision_toolbox_tpu/models/base.py``.

Every backbone exposes ``get_feature_maps(x) -> list``, ``out_channels_list``
and ``stride``; ``forward`` returns the last feature map. Models register a
factory under a string name for ``create_backbone``.
"""

from __future__ import annotations

from typing import Any, Callable

from torch import Tensor, nn


class Backbone(nn.Module):
    """Abstract backbone: subclasses implement ``get_feature_maps`` only."""

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
