"""Optimizer and learning-rate schedule of the reference recipe — port of
``vision_toolbox_tpu/train/optim.py``.

- Three weight-decay groups: norm parameters (BatchNorm/LayerNorm weight
  and bias), biases, and everything else (``param_group``).
- Five optimizers, each equal to the JAX package's optax chain
  (``make_optimizer``): SGD with torch semantics (the group's decay added to
  the gradient before momentum, the momentum buffer starting as the first
  decayed gradient); RMSprop (the group's decay added to the gradient,
  torch's alpha 0.99 and eps 1e-8 outside the square root, then the
  learning rate, then momentum on the scaled update, as optax orders it);
  AdamW and LAMB (the group's decay added after ``scale_by_adam``, LAMB's
  before its per-tensor trust ratio); LARS (``optax.lars``: its own decay
  on every parameter, the trust ratio at coefficient 1e-3, the learning
  rate, then momentum). Each reads the learning rate from the schedule at
  its count of updates before the update, and each step is the separately
  rounded f32 chain that optax computes.
- Gradient accumulation with ``optax.MultiSteps``' semantics
  (``MultiSteps``): the running mean of k micro-gradients is applied every
  k micro-steps.
- Linear warmup then cosine annealing, per epoch (``epoch_granularity``) or
  per step, evaluated in float32 as the JAX schedule is.
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


class GroupedOptimizer:
    """An optimizer over groups of (weight decay, parameters) that reads
    ``.grad`` and updates the parameters in place with ``torch._foreach_*``
    ops per group. ``learning_rate`` is a float or a schedule lr(count);
    ``count`` is the number of updates made. Subclasses name their state
    (``STATE``: attributes holding one list of tensors per group, or None
    before the first update) and implement ``_update``."""

    STATE: tuple[str, ...] = ()

    def __init__(self, groups: list[tuple[float, list[nn.Parameter]]],
                 learning_rate: float | Callable[[int], float]):
        self.groups = [(wd, list(ps)) for wd, ps in groups if ps]
        self.learning_rate = learning_rate
        self.count = 0
        for name in self.STATE:
            setattr(self, name, None)

    def zero_grad(self) -> None:
        for _, ps in self.groups:
            for p in ps:
                p.grad = None

    def current_lr(self) -> float:
        """The learning rate of the next update (the count before it, as
        optax reads it)."""
        lr = self.learning_rate
        return lr(self.count) if callable(lr) else lr

    @torch.no_grad()
    def step(self) -> None:
        lr = self.current_lr()
        for i, (wd, ps) in enumerate(self.groups):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
            self._update(i, wd, ps, grads, lr)
        self.count += 1

    def _update(self, i: int, wd: float, ps: list[Tensor], grads: list[Tensor],
                lr: float) -> None:
        raise NotImplementedError

    def _zeros(self, name: str) -> list[list[Tensor]]:
        """State ``name``, made of zeros (optax's init) where it is None."""
        if getattr(self, name) is None:
            setattr(self, name, [[torch.zeros_like(p) for p in ps] for _, ps in self.groups])
        return getattr(self, name)

    def state_dict(self) -> dict:
        return {"count": self.count, **{name: getattr(self, name) for name in self.STATE}}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s values onto the parameters' devices."""
        self.count = int(state["count"])
        for name in self.STATE:
            lists = state[name]
            if lists is not None:
                lists = [[t.to(p.device) for t, p in zip(ts, ps)]
                         for ts, (_, ps) in zip(lists, self.groups)]
            setattr(self, name, lists)


def _decayed(ps: list[Tensor], grads: list[Tensor], wd: float) -> list[Tensor]:
    """g + wd·p (optax ``add_decayed_weights``); g itself where wd is 0."""
    if not wd:
        return grads
    d = torch._foreach_mul(ps, wd)
    torch._foreach_add_(d, grads)
    return d


def _trace(buffers: list[Tensor], updates: list[Tensor], momentum: float) -> None:
    """buf = u + m·buf in place (optax ``trace`` from its zero init)."""
    torch._foreach_mul_(buffers, momentum)
    torch._foreach_add_(buffers, updates)


def _trust_ratio(ps: list[Tensor], updates: list[Tensor], coefficient: float) -> list[Tensor]:
    """optax ``scale_by_trust_ratio``: u · c‖p‖/‖u‖ per tensor, u itself
    where either norm is 0."""
    out = []
    for p, u in zip(ps, updates):
        pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        ratio = torch.where((pn == 0) | (un == 0), 1.0, coefficient * pn / un)
        out.append(u * ratio)
    return out


def _moment(moments: list[Tensor], updates: list[Tensor], decay: float, order: int) -> None:
    """m = (1 − decay)·g^order + decay·m in place (optax's moment update)."""
    torch._foreach_mul_(moments, decay)
    g = updates if order == 1 else torch._foreach_mul(updates, updates)
    torch._foreach_add_(moments, torch._foreach_mul(g, 1.0 - decay))


class SGD(GroupedOptimizer):
    """SGD with momentum and per-group weight decay, torch semantics; each
    step is the separately rounded f32 chain
    ``d = g + wd·p; buf = d + m·buf; p = p + (−lr)·buf``."""

    STATE = ("buffers",)

    def __init__(self, groups: list[tuple[float, list[nn.Parameter]]],
                 learning_rate: float | Callable[[int], float], momentum: float = 0.9,
                 nesterov: bool = False):
        super().__init__(groups, learning_rate)
        self.momentum, self.nesterov = momentum, nesterov

    def _update(self, i, wd, ps, grads, lr):
        d = _decayed(ps, grads, wd)
        upd = d
        if self.momentum:
            if self.buffers is None:
                self.buffers = [None] * len(self.groups)
            if self.buffers[i] is None:
                self.buffers[i] = [g.clone() for g in d]  # g + m·0
            else:
                _trace(self.buffers[i], d, self.momentum)
            upd = self.buffers[i]
            if self.nesterov:
                upd = torch._foreach_mul(upd, self.momentum)
                torch._foreach_add_(upd, d)
        torch._foreach_add_(ps, torch._foreach_mul(upd, -lr))


class RMSprop(GroupedOptimizer):
    """optax's chain for "rmsprop": d = g + wd·p; ν = 0.01·d² + 0.99·ν;
    u = −lr · d / (√ν + 1e-8); buf = u + m·buf; p = p + buf."""

    STATE = ("nu", "trace")

    def __init__(self, groups, learning_rate, momentum: float = 0.9, decay: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(groups, learning_rate)
        self.momentum, self.decay, self.eps = momentum, decay, eps

    def _update(self, i, wd, ps, grads, lr):
        d = _decayed(ps, grads, wd)
        nu = self._zeros("nu")[i]
        _moment(nu, d, self.decay, 2)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_reciprocal_(denom)
        u = torch._foreach_mul(denom, d)
        torch._foreach_mul_(u, -lr)
        if self.momentum:
            buf = self._zeros("trace")[i]
            _trace(buf, u, self.momentum)
            u = buf
        torch._foreach_add_(ps, u)


class Adam(GroupedOptimizer):
    """optax's chains for "adamw" and "lamb": ``scale_by_adam`` (b1 0.9, b2
    0.999, eps 1e-8, bias-corrected at the update's count), then the group's
    decay, then (``trust_ratio``, LAMB) optax's per-tensor trust ratio,
    then −lr."""

    STATE = ("mu", "nu")

    def __init__(self, groups, learning_rate, trust_ratio: bool = False, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(groups, learning_rate)
        self.trust_ratio, self.b1, self.b2, self.eps = trust_ratio, b1, b2, eps

    def _update(self, i, wd, ps, grads, lr):
        mu, nu = self._zeros("mu")[i], self._zeros("nu")[i]
        _moment(mu, grads, self.b1, 1)
        _moment(nu, grads, self.b2, 2)
        n = torch.tensor(float(self.count + 1))
        c1 = (1 - torch.tensor(self.b1) ** n).item()  # f32, as optax's bias correction
        c2 = (1 - torch.tensor(self.b2) ** n).item()
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, c1)
        torch._foreach_div_(u, denom)
        if wd:
            torch._foreach_add_(u, torch._foreach_mul(ps, wd))
        if self.trust_ratio:
            u = _trust_ratio(ps, u, 1.0)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(ps, u)


class LARS(GroupedOptimizer):
    """``optax.lars``: d = g + wd·p on every parameter (its own decay, not
    the groups'), u = d · 1e-3·‖p‖/‖d‖ per tensor, −lr, then momentum."""

    STATE = ("trace",)

    def __init__(self, groups, learning_rate, momentum: float = 0.9,
                 trust_coefficient: float = 1e-3):
        super().__init__(groups, learning_rate)
        self.momentum, self.trust_coefficient = momentum, trust_coefficient

    def _update(self, i, wd, ps, grads, lr):
        u = _trust_ratio(ps, _decayed(ps, grads, wd), self.trust_coefficient)
        torch._foreach_mul_(u, -lr)
        buf = self._zeros("trace")[i]
        _trace(buf, u, self.momentum)
        torch._foreach_add_(ps, buf)


class MultiSteps:
    """Gradient accumulation with ``optax.MultiSteps``' semantics around an
    optimizer: every ``step()`` folds the parameters' gradients into a
    running mean (``acc + (g − acc)/(n + 1)``), and every k-th hands the mean
    to ``inner`` and starts again from zero. ``count`` is the inner
    optimizer's count of updates (what the schedule reads); ``mini_step``
    the micro-steps since the last update."""

    def __init__(self, inner: GroupedOptimizer, every_k: int):
        self.inner, self.every_k = inner, every_k
        self.mini_step = 0
        self.acc: list[list[Tensor]] | None = None

    @property
    def groups(self):
        return self.inner.groups

    @property
    def count(self) -> int:
        return self.inner.count

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    @torch.no_grad()
    def step(self) -> None:
        if self.acc is None:
            self.acc = [[torch.zeros_like(p) for p in ps] for _, ps in self.groups]
        for acc, (_, ps) in zip(self.acc, self.groups):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
            delta = torch._foreach_sub(grads, acc)
            torch._foreach_div_(delta, self.mini_step + 1)
            torch._foreach_add_(acc, delta)
        if self.mini_step == self.every_k - 1:
            for acc, (_, ps) in zip(self.acc, self.groups):
                for p, a in zip(ps, acc):
                    p.grad = a
            self.inner.step()
            self.inner.zero_grad()
            self.acc = None
        self.mini_step = (self.mini_step + 1) % self.every_k

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "acc": self.acc, "inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.mini_step = int(state["mini_step"])
        acc = state["acc"]
        self.acc = None if acc is None else [[t.to(p.device) for t, p in zip(ts, ps)]
                                             for ts, (_, ps) in zip(acc, self.groups)]
        self.inner.load_state_dict(state["inner"])


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
) -> GroupedOptimizer:
    """Optimizer by name — sgd / rmsprop / adamw / lamb / lars — with the
    three weight-decay groups (lars: its own decay on every parameter)."""
    name = name.lower()
    groups = _grouped_parameters(model, weight_decay, norm_weight_decay, bias_weight_decay)
    if name == "sgd":
        return SGD(groups, learning_rate, momentum=momentum, nesterov=nesterov)
    if name == "rmsprop":
        return RMSprop(groups, learning_rate, momentum=momentum)
    if name in ("adamw", "lamb"):
        return Adam(groups, learning_rate, trust_ratio=name == "lamb")
    if name == "lars":
        return LARS([(weight_decay, list(model.parameters()))], learning_rate,
                    momentum=momentum)
    raise ValueError(f"unsupported optimizer {name!r}")
