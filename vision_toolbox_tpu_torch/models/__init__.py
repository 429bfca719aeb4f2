"""Model registry and backbones."""

# importing each model module registers its names (cait_*, convnext*, darknet*,
# deit*, mixer_*, patchconvnet_*, swin_*, vit_*, vovnet*)
from . import (  # noqa: F401
    cait, convnext, darknet, deit, mlp_mixer, patchconvnet, swin, vit, vovnet,
)
from .base import Backbone, create_backbone, list_backbones, register_model
from .cait import CaiT, cait_from_config
from .convnext import ConvNeXt, convnext_from_config
from .darknet import Darknet, DarknetYOLOv5
from .deit import DeiT
from .mlp_mixer import MLPMixer, mlp_mixer_from_config
from .patchconvnet import PatchConvNet, patchconvnet_from_config
from .swin import SwinTransformer, resize_window_tables, swin_from_config
from .vit import VIT_VARIANTS, ViT, vit_from_config
from .vovnet import VoVNet, vovnet_from_config

__all__ = [
    "Backbone", "CaiT", "ConvNeXt", "Darknet", "DarknetYOLOv5", "DeiT", "MLPMixer", "PatchConvNet",
    "VIT_VARIANTS", "ViT", "VoVNet", "cait", "cait_from_config", "convnext",
    "convnext_from_config", "create_backbone", "darknet", "deit", "list_backbones",
    "mlp_mixer", "mlp_mixer_from_config", "patchconvnet", "patchconvnet_from_config",
    "register_model", "resize_window_tables", "swin", "swin_from_config", "SwinTransformer",
    "vit", "vit_from_config", "vovnet", "vovnet_from_config",
]
