"""Model registry and backbones."""

from . import cait, convnext, darknet, deit, swin, vit  # noqa: F401  (register the cait_*, convnext*, darknet*, deit*, swin_*, vit_* names)
from .base import Backbone, create_backbone, list_backbones, register_model
from .cait import CaiT, cait_from_config
from .convnext import ConvNeXt, convnext_from_config
from .darknet import Darknet, DarknetYOLOv5
from .deit import DeiT
from .swin import SwinTransformer, resize_window_tables, swin_from_config
from .vit import VIT_VARIANTS, ViT, vit_from_config

__all__ = [
    "Backbone", "CaiT", "ConvNeXt", "Darknet", "DarknetYOLOv5", "DeiT", "VIT_VARIANTS", "ViT",
    "cait", "cait_from_config", "convnext", "convnext_from_config", "create_backbone", "darknet",
    "deit", "list_backbones", "register_model", "resize_window_tables", "swin", "swin_from_config",
    "SwinTransformer", "vit", "vit_from_config",
]
