"""The recipe's first train steps in plain PyTorch, f32 (TF32 off), from
the benchmark's weights, store and index vectors: the draws, the input
pipeline (``augment.py``), the forward and backward of ``models.py``, the
label-smoothed cross entropy and SGD with momentum and three weight-decay
groups. Reads per-leaf norms: of the first step's gradient and of the
parameters' change over the steps.
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import augment


def param_group(name: str) -> str:
    """'norm' (the weight and bias of a module named like a norm), 'bias',
    or 'other', the recipe's three weight-decay groups."""
    path = name.split(".")
    leaf, parent = path[-1], (path[-2] if len(path) > 1 else "").lower()
    if leaf in ("weight", "bias") and ("norm" in parent or parent.startswith("ln")):
        return "norm"
    return "bias" if leaf == "bias" else "other"


def warmup_lr(recipe: dict, count: int, steps_per_epoch: int) -> float:
    """The recipe's warmup learning rate at update ``count``, per epoch."""
    t = recipe["train"]
    epoch = count // steps_per_epoch
    if epoch >= t["warmup_epochs"]:
        raise ValueError("the reference follows steps of the warmup only")
    f = t["warmup_factor"]
    return float(torch.tensor(t["lr"] * (f + (1.0 - f) * epoch / max(t["warmup_epochs"], 1)),
                              dtype=torch.float32))


def cross_entropy(logits: Tensor, targets: Tensor, smoothing: float) -> Tensor:
    targets = targets * (1.0 - smoothing) + smoothing / logits.shape[-1]
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def leaf_norms(tensors: dict[str, Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def run(model: torch.nn.Module, store: Tensor, labels: Tensor, idx: list[Tensor],
        recipe: dict, steps_per_epoch: int) -> dict:
    """Follow ``len(idx)`` steps, their draws seeded from the recipe's
    ``train.seed``. Returns the losses, the per-leaf norms of the first
    gradient and of the parameters' change, on the host."""
    data, train = recipe["data"], recipe["train"]
    decay = {"other": train["weight_decay"], "norm": 0.0, "bias": 0.0}
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    buffers: dict[str, Tensor] = {}
    losses, grad_norms = [], {}
    for n, rows in enumerate(idx):
        seed_n = augment.step_seed(train["seed"] + 1, n)
        g = torch.Generator(device=store.device).manual_seed(seed_n)
        d = augment.draw_step(g, len(rows), store.shape[1], data["train_crop_size"],
                              data["random_erasing_p"], train["cutmix_alpha"],
                              train["mixup_alpha"])
        x, t = augment.pipeline(store, labels, rows.to(store.device), d,
                                data["train_crop_size"], recipe["model"]["num_classes"])
        for p in params.values():
            p.grad = None
        loss = cross_entropy(model(x), t, train["label_smoothing"])
        loss.backward()
        losses.append(loss.item())
        if n == 0:
            grad_norms = leaf_norms({k: p.grad for k, p in params.items()})
        lr = warmup_lr(recipe, n, steps_per_epoch)
        with torch.no_grad():
            for k, p in params.items():
                step = p.grad + decay[param_group(k)] * p if decay[param_group(k)] else p.grad
                buffers[k] = step.clone() if n == 0 else buffers[k] * train["momentum"] + step
                p.add_(buffers[k], alpha=-lr)
        del x, t, loss
    change = leaf_norms({k: p.detach() - start[k] for k, p in params.items()})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
