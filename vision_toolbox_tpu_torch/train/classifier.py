"""Image classifier = backbone + global average pool + linear head — port of
``vision_toolbox_tpu/train/classifier.py``, with the label-smoothed cross
entropy and top-1 accuracy."""

from __future__ import annotations

import torch
from torch import Tensor, nn

from ..nn.layers import Linear


class ImageClassifier(nn.Module):
    """``head(mean_hw(backbone(x)))`` with float32 logits. Conv backbones
    return NHWC maps and are pooled; token models return pooled (B, C)
    features. ``dtype`` is the head's compute type; its parameters are f32."""

    def __init__(self, backbone: nn.Module, num_classes: int, include_pool: bool = True, *,
                 dtype: torch.dtype | None = None, generator: torch.Generator | None = None):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.backbone = backbone
        self.include_pool = include_pool
        self.head = Linear(backbone.last_out_channels, num_classes, dtype=dtype, generator=gen)
        device = next(backbone.parameters()).device
        self.head.to(device)

    def forward(self, x: Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> Tensor:
        x = self.backbone(x, train=train, generator=generator)
        if self.include_pool and x.ndim == 4:
            x = x.mean(dim=(1, 2))
        return self.head(x).float()


def cross_entropy(logits: Tensor, targets: Tensor, label_smoothing: float = 0.0) -> Tensor:
    """Mean cross entropy with label smoothing over int class ids or (N, C)
    soft targets."""
    num_classes = logits.shape[-1]
    if targets.ndim == logits.ndim - 1:
        targets = torch.nn.functional.one_hot(targets.long(), num_classes).to(logits.dtype)
    if label_smoothing > 0:
        targets = targets * (1.0 - label_smoothing) + label_smoothing / num_classes
    log_probs = torch.log_softmax(logits, dim=-1)
    return -(targets * log_probs).sum(dim=-1).mean()


def accuracy(logits: Tensor, labels: Tensor) -> Tensor:
    """Top-1 accuracy."""
    return (logits.argmax(dim=-1) == labels).float().mean()
