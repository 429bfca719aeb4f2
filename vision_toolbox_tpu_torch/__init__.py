"""vision_toolbox_tpu_torch — the PyTorch/CUDA port of ``vision_toolbox_tpu``.

It serves and trains ViT/DeiT backbones on an NVIDIA H100 (the transformer
blocks run hand-written CUDA kernels for the fused attention and MLP
half-blocks, forward and backward, ``ops/block_attention.py``,
``ops/block_mlp.py``) and trains the Darknet family with the full recipe
(``train/``; TrivialAugment's geometric ops run the hand-written three-shear
warp kernel, ``ops/warp.py``). Kernel sources are in ``csrc/``, built with
``nvcc`` at first use. Models are built on the card unless ``device="cpu"``
is passed. The JAX package is the reference the port is held against; this
package imports ``torch`` and never ``jax``, and every random draw takes an
explicit ``torch.Generator``.

    import torch, vision_toolbox_tpu_torch as vtt
    model = vtt.create_backbone("vit_b_16", dtype=torch.bfloat16)
    feats = model(torch.rand(8, 224, 224, 3, device="cuda"))  # NHWC in, (8, 768) out
"""

from . import models
from .models.base import Backbone, create_backbone, list_backbones, register_model

__all__ = ["Backbone", "create_backbone", "list_backbones", "models", "register_model"]
