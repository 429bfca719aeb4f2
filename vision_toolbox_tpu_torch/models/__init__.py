"""Model registry and backbones."""

# importing each model module registers its names (cait_*, convnext*, darknet*,
# deit*, efficientnet_*, mixer_*, mobilenet_v3_*, patchconvnet_*, regnet_*,
# resnet*, resnext*, wide_resnet*, swin_*, vit_*, vovnet*); the necks register none
from . import (  # noqa: F401
    cait, convnext, darknet, deit, efficientnet, mlp_mixer, mobilenet, necks, patchconvnet,
    regnet, resnet, swin, vit, vovnet,
)
from .base import Backbone, create_backbone, list_backbones, register_model
from .cait import CaiT, cait_from_config
from .convnext import ConvNeXt, convnext_from_config
from .darknet import Darknet, DarknetYOLOv5
from .deit import DeiT
from .efficientnet import EfficientNet, efficientnet_from_config
from .mbconv import MBConv, make_divisible
from .mlp_mixer import MLPMixer, mlp_mixer_from_config
from .mobilenet import MobileNetV3, mobilenet_from_config
from .necks import BiFPN, BiFPNLayer, FPN, PAN, WeightedFeatureFusion, resize_nearest
from .patchconvnet import PatchConvNet, patchconvnet_from_config
from .regnet import RegNet, RegNetBlock, regnet_from_config
from .resnet import BasicBlock, Bottleneck, ResNet, resnet_from_config
from .swin import SwinTransformer, resize_window_tables, swin_from_config
from .vit import VIT_VARIANTS, ViT, vit_from_config
from .vovnet import VoVNet, vovnet_from_config

__all__ = [
    "Backbone", "BasicBlock", "BiFPN", "BiFPNLayer", "Bottleneck", "CaiT", "ConvNeXt", "Darknet",
    "DarknetYOLOv5", "DeiT", "EfficientNet", "FPN", "MBConv", "MLPMixer", "MobileNetV3", "PAN",
    "PatchConvNet", "RegNet", "RegNetBlock", "ResNet", "VIT_VARIANTS", "ViT", "VoVNet",
    "WeightedFeatureFusion", "cait", "cait_from_config", "convnext", "convnext_from_config",
    "create_backbone", "darknet", "deit", "efficientnet", "efficientnet_from_config",
    "list_backbones", "make_divisible", "mlp_mixer", "mlp_mixer_from_config", "mobilenet",
    "mobilenet_from_config", "necks", "patchconvnet", "patchconvnet_from_config", "regnet",
    "regnet_from_config", "register_model", "resize_nearest", "resize_window_tables", "resnet",
    "resnet_from_config", "swin", "swin_from_config", "SwinTransformer", "vit",
    "vit_from_config", "vovnet", "vovnet_from_config",
]
