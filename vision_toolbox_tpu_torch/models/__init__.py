"""Model registry and backbones."""

from . import darknet, vit  # noqa: F401  (register the darknet* and vit_* names)
from .base import Backbone, create_backbone, list_backbones, register_model
from .darknet import Darknet, DarknetYOLOv5
from .vit import VIT_VARIANTS, ViT, vit_from_config

__all__ = [
    "Backbone", "Darknet", "DarknetYOLOv5", "VIT_VARIANTS", "ViT", "create_backbone",
    "darknet", "list_backbones", "register_model", "vit", "vit_from_config",
]
