"""Model registry and backbones."""

from . import vit  # noqa: F401  (registers the vit_* names)
from .base import Backbone, create_backbone, list_backbones, register_model
from .vit import VIT_VARIANTS, ViT, vit_from_config

__all__ = [
    "Backbone", "VIT_VARIANTS", "ViT", "create_backbone", "list_backbones", "register_model",
    "vit", "vit_from_config",
]
