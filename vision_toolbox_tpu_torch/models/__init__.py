"""Model registry and backbones."""

from . import darknet, deit, vit  # noqa: F401  (register the darknet*, deit*, vit_* names)
from .base import Backbone, create_backbone, list_backbones, register_model
from .darknet import Darknet, DarknetYOLOv5
from .deit import DeiT
from .vit import VIT_VARIANTS, ViT, vit_from_config

__all__ = [
    "Backbone", "Darknet", "DarknetYOLOv5", "DeiT", "VIT_VARIANTS", "ViT", "create_backbone",
    "darknet", "deit", "list_backbones", "register_model", "vit", "vit_from_config",
]
