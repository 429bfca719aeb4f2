"""vision_toolbox_tpu_torch — the PyTorch/CUDA port of ``vision_toolbox_tpu``.

It serves and trains ViT/DeiT backbones on an NVIDIA H100 (the transformer
blocks run hand-written CUDA kernels for the fused attention and MLP
half-blocks, forward and backward, ``ops/block_attention.py``,
``ops/block_mlp.py``), serves and trains CaiT (its talking-head attention
runs hand-written forward and backward kernels, ``ops/cait_attention.py``;
its MLP halves the fused MLP kernels), serves and trains SigLIP ViTs at 512 px
(attention over T = 1024 tokens runs hand-written flash-attention kernels,
``ops/flash_attention.py``), serves and trains ConvNeXt (hand-written
depthwise-conv kernels, ``ops/depthwise_conv.py``) and Swin (hand-written
window-attention and shifted-window relayout kernels,
``ops/swin_attention.py``, ``ops/swin_relayout.py``), serves and trains
MLP-Mixer (its channel halves the fused MLP kernels) and PatchConvNet (its
3 × 3 depthwise convs the depthwise-conv kernels), EfficientNet and
MobileNetV3 (their stride-1 MBConv depthwise convs the depthwise-conv
kernels at 3 × 3 and 5 × 5), ResNet/ResNeXt/Wide-ResNet and RegNet X/Y,
trains the Darknet family and VoVNet with the full recipe (``train/``;
TrivialAugment's geometric ops run the hand-written three-shear warp
kernel, ``ops/warp.py``), and holds the detection necks FPN, PAN and BiFPN
(its separable convs on the depthwise-conv kernels, ``models/necks.py``)
and the deformable conv (``ops/deform_conv.py``); loads the published
checkpoints (``load_pretrained``: the official ``.pth`` and ``.npz``
layouts), serves them in int8 (``utils/int8_serving.py``) and profiles a
model (``utils/profile.py``). Kernel sources are in ``csrc/``, built with
``nvcc`` at first use. Models are built on the card unless ``device="cpu"``
is passed. The JAX package is the reference the port is held against; this
package imports ``torch`` and never ``jax``, and every random draw takes an
explicit ``torch.Generator``.

    import torch, vision_toolbox_tpu_torch as vtt
    model = vtt.create_backbone("vit_b_16", dtype=torch.bfloat16)
    feats = model(torch.rand(8, 224, 224, 3, device="cuda"))  # NHWC in, (8, 768) out
    model = vtt.load_pretrained("vit_b_16", dtype=torch.bfloat16)  # AugReg weights
"""

from . import models
from .models.base import Backbone, create_backbone, list_backbones, register_model
from .models.pretrained import load_pretrained

__all__ = ["Backbone", "create_backbone", "list_backbones", "load_pretrained", "models",
           "register_model"]
