"""Optimizer and learning-rate schedule of the reference recipe — port of
``vision_toolbox_tpu/train/optim.py``.

- Three weight-decay groups: norm parameters (BatchNorm/LayerNorm weight
  and bias), biases, and everything else (``param_group``).
- SGD with torch semantics, equal to the JAX package's optax chain: the
  group's decay is added to the gradient before momentum, the momentum
  buffer starts as the first (decayed) gradient, and the learning rate is
  read from the schedule at the step count before the update.
- Linear warmup then cosine annealing, per epoch (``epoch_granularity``) or
  per step, evaluated in float32 as the JAX schedule is.

Only SGD is ported so far; ``make_optimizer`` raises for the others.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import Tensor, nn

GROUPS = ("other", "norm", "bias")


def _is_norm_module(name: str) -> bool:
    name = name.lower()
    return "norm" in name or name.startswith("ln")


def param_group(path: tuple[str, ...]) -> str:
    """'norm' / 'bias' / 'other' for a parameter name split at the dots.

    The port names a norm's scale ``weight`` (flax: ``scale``), so a
    ``weight`` or ``bias`` under a module named like a norm (containing
    "norm" or starting with "ln") is a norm parameter; any other ``bias``
    is a bias; the rest is 'other'."""
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if leaf in ("weight", "bias") and _is_norm_module(parent):
        return "norm"
    return "bias" if leaf == "bias" else "other"


def warmup_cosine_schedule(
    base_lr: float, total_epochs: int, steps_per_epoch: int, warmup_epochs: int = 5,
    warmup_factor: float = 0.01, decay_factor: float = 0.0, epoch_granularity: bool = True,
) -> Callable[[int], float]:
    """LinearLR(warmup_factor) for ``warmup_epochs``, then CosineAnnealingLR
    to ``base_lr·decay_factor``. Returns lr(step) as a Python float."""
    eta_min = base_lr * decay_factor
    t_max = max(total_epochs - warmup_epochs, 1)

    def schedule(step: int) -> float:
        e = torch.tensor(step, dtype=torch.float32) / steps_per_epoch
        if epoch_granularity:
            e = torch.floor(e)
        warm = base_lr * (warmup_factor + (1.0 - warmup_factor) * torch.clamp(e, max=warmup_epochs)
                          / max(warmup_epochs, 1))
        prog = torch.clamp((e - warmup_epochs) / t_max, 0.0, 1.0)
        cos = eta_min + (base_lr - eta_min) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        if warmup_epochs == 0:
            return cos.item()
        return (warm if e < warmup_epochs else cos).item()

    return schedule


class SGD:
    """SGD with momentum and per-group weight decay, torch semantics.

    ``groups`` is a list of (weight decay, parameters); ``learning_rate`` a
    float or a schedule lr(step). ``count`` is the number of updates made.
    Works in place on the parameters, with ``torch._foreach_*`` ops per
    group; each step is the separately rounded f32 chain
    ``d = g + wd·p; buf = d + m·buf; p = p + (−lr)·buf``."""

    def __init__(self, groups: list[tuple[float, list[nn.Parameter]]],
                 learning_rate: float | Callable[[int], float], momentum: float = 0.9,
                 nesterov: bool = False):
        self.groups = [(wd, list(ps)) for wd, ps in groups if ps]
        self.learning_rate = learning_rate
        self.momentum, self.nesterov = momentum, nesterov
        self.buffers: list[list[Tensor]] | None = None
        self.count = 0

    def zero_grad(self) -> None:
        for _, ps in self.groups:
            for p in ps:
                p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        lr = self.learning_rate
        if callable(lr):
            lr = lr(self.count)  # the count before this update, as optax reads it
        new_buffers = []
        for i, (wd, ps) in enumerate(self.groups):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
            if wd:
                d = torch._foreach_mul(ps, wd)
                torch._foreach_add_(d, grads)
            else:
                d = grads
            if self.momentum:
                if self.buffers is None:
                    buf = [g.clone() for g in d]  # g + m·0
                else:
                    buf = self.buffers[i]
                    torch._foreach_mul_(buf, self.momentum)
                    torch._foreach_add_(buf, d)
                new_buffers.append(buf)
                if self.nesterov:
                    upd = torch._foreach_mul(buf, self.momentum)
                    torch._foreach_add_(upd, d)
                else:
                    upd = buf
            else:
                upd = d
            torch._foreach_add_(ps, torch._foreach_mul(upd, -lr))
        if self.momentum:
            self.buffers = new_buffers
        self.count += 1


def _grouped_parameters(model: nn.Module, weight_decay: float, norm_weight_decay: float,
                        bias_weight_decay: float) -> list[tuple[float, list[nn.Parameter]]]:
    """The model's parameters split by ``param_group``, each with its decay."""
    decay = {"other": weight_decay, "norm": norm_weight_decay, "bias": bias_weight_decay}
    split: dict[str, list[nn.Parameter]] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        split[param_group(tuple(name.split(".")))].append(p)
    return [(decay[g], split[g]) for g in GROUPS]


def sgd_with_param_groups(
    model: nn.Module, learning_rate: float | Callable[[int], float], momentum: float = 0.9,
    weight_decay: float = 2e-5, norm_weight_decay: float = 0.0, bias_weight_decay: float = 0.0,
    nesterov: bool = False,
) -> SGD:
    """torch.optim.SGD semantics with the reference's 3-group weight decay."""
    return make_optimizer("sgd", model, learning_rate, momentum=momentum,
                          weight_decay=weight_decay, norm_weight_decay=norm_weight_decay,
                          bias_weight_decay=bias_weight_decay, nesterov=nesterov)


def make_optimizer(
    name: str, model: nn.Module, learning_rate: float | Callable[[int], float],
    momentum: float = 0.9, weight_decay: float = 2e-5, norm_weight_decay: float = 0.0,
    bias_weight_decay: float = 0.0, nesterov: bool = False,
) -> SGD:
    """Optimizer by name with per-group weight decay. Only "sgd" is ported."""
    name = name.lower()
    if name == "sgd":
        groups = _grouped_parameters(model, weight_decay, norm_weight_decay, bias_weight_decay)
        return SGD(groups, learning_rate, momentum=momentum, nesterov=nesterov)
    if name in ("rmsprop", "adamw", "lamb", "lars"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet: the port's train-step slice "
            "(CSPDarknet-53 full recipe) brings 'sgd' only"
        )
    raise ValueError(f"unsupported optimizer {name!r}")
