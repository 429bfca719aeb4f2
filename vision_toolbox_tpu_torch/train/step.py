"""Train and eval steps — port of ``vision_toolbox_tpu/train/step.py``.

``make_train_step`` builds the full-recipe step, in the JAX package's order:
uint8 → f32/255, TrivialAugmentWide, RandomErasing, cast to the compute
dtype, one-hot, CutMix⊕MixUp, forward/backward (f32 parameters, compute in
``compute_dtype``, label-smoothed cross entropy), SGD, BatchNorm running
stats (updated during the forward). Every random draw comes from the
``torch.Generator`` the step is given, or from ``draws`` given explicitly
(the tests pass the JAX package's draws this way). Images are NHWC, uint8 or
float in [0, 1], on the model's device.

``make_device_data_train_step`` runs the same step on a train set resident
on the device (gather, /255, ``ops/device_rrc.py``'s RandomResizedCrop and
flip, then the full recipe); ``make_eval_accumulate_step`` folds the eval
metrics into a (4,) accumulator on the device. The sharded variants of the
JAX package are not ported (one device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import Tensor, nn

from ..ops.augment import (
    EraseDraws,
    MixDraws,
    cutmix_mixup,
    host_rng,
    one_hot_labels,
    random_erasing,
    sample_mix,
    sample_random_erasing,
)
from ..ops.device_rrc import RRCDraws, crop_resize_flip, sample_rrc
from ..ops.trivial_augment import TADraws, sample_trivial_augment, trivial_augment_wide_apply
from .classifier import cross_entropy
from .optim import GroupedOptimizer, MultiSteps


@dataclass
class TrainState:
    """The model, its optimizer and ``step``, the number of train-step calls
    (micro-steps under gradient accumulation), as the JAX ``TrainState``
    counts them."""

    model: nn.Module
    optimizer: GroupedOptimizer | MultiSteps
    step: int = 0


class StepDraws(NamedTuple):
    """All random draws of one train step; None where the recipe has no such
    op."""

    ta: TADraws | None = None
    erase: EraseDraws | None = None
    mix: MixDraws | None = None


def make_train_step(
    num_classes: int,
    label_smoothing: float = 0.1,
    mixup_alpha: float = 0.2,
    cutmix_alpha: float = 1.0,
    trivial_augment: bool = False,
    random_erasing_p: float = 0.0,
    compute_dtype: torch.dtype = torch.float32,
):
    """Build the train step ``step(state, images, labels, generator=None,
    draws=None) -> {"loss": 0-d tensor}``; it updates ``state`` in place.
    ``step.sample_draws(generator, shape)`` draws a step's randomness and
    ``step.augment(images, labels, draws)`` runs its input pipeline alone."""
    mix = mixup_alpha > 0 or cutmix_alpha > 0

    def sample_draws(generator: torch.Generator, shape: tuple[int, int, int, int]) -> StepDraws:
        B, H, W, _ = shape
        return StepDraws(
            ta=sample_trivial_augment(generator, B) if trivial_augment else None,
            erase=(sample_random_erasing(generator, shape, random_erasing_p)
                   if random_erasing_p > 0 else None),
            mix=(sample_mix(host_rng(generator), H, W, cutmix_alpha, mixup_alpha)
                 if mix else None),
        )

    def augment(images: Tensor, labels: Tensor, draws: StepDraws) -> tuple[Tensor, Tensor]:
        """The step's input pipeline: (images in compute dtype, soft targets)."""
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        if trivial_augment:
            images = trivial_augment_wide_apply(images.float(), draws.ta)
        if random_erasing_p > 0:
            images = random_erasing(images.float(), draws.erase)
        images = images.to(compute_dtype)
        targets = one_hot_labels(labels.to(images.device), num_classes)
        if mix:
            images, targets = cutmix_mixup(images, targets, draws.mix)
        return images, targets

    def train_step(state: TrainState, images: Tensor, labels: Tensor,
                   generator: torch.Generator | None = None,
                   draws: StepDraws | None = None) -> dict[str, Tensor]:
        if draws is None:
            if generator is None:
                raise ValueError("the train step needs a torch.Generator or explicit draws")
            draws = sample_draws(generator, tuple(images.shape))
        images, targets = augment(images, labels, draws)

        state.optimizer.zero_grad()
        logits = state.model(images, train=True, generator=generator)
        loss = cross_entropy(logits, targets, label_smoothing)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    train_step.sample_draws = sample_draws
    train_step.augment = augment
    return train_step


class DeviceStepDraws(NamedTuple):
    """The draws of one device-resident step: the crop boxes and flips, then
    the recipe's."""

    rrc: RRCDraws
    step: StepDraws


def make_device_data_train_step(
    num_classes: int,
    crop_size: int,
    rrc_scale: tuple[float, float] = (0.08, 1.0),
    rrc_ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    hflip_p: float = 0.5,
    **train_step_kwargs,
):
    """Train step over a train set resident on the device (decoded once into
    device memory). Per step the host ships only a (B,) index vector; the
    gather, RandomResizedCrop(crop_size) + flip (``ops/device_rrc.py``, two
    batched products) and the full recipe of ``make_train_step`` all run on
    the device.

    ``step(state, store_images (N, S, S, C) uint8, store_labels (N,) int,
    idx (B,) int, generator=None, draws=None) -> {"loss"}``: the crop draws
    come first from ``generator``, then the recipe's; or both from
    ``draws`` (a ``DeviceStepDraws``). ``step.sample_draws(generator, batch,
    src_h, src_w)`` draws them alone."""
    inner = make_train_step(num_classes, **train_step_kwargs)

    def sample_draws(generator: torch.Generator, batch: int, src_h: int,
                     src_w: int) -> DeviceStepDraws:
        rrc = sample_rrc(generator, batch, src_h, src_w, rrc_scale, rrc_ratio, hflip_p)
        shape = (batch, crop_size, crop_size, 3)
        return DeviceStepDraws(rrc, inner.sample_draws(generator, shape))

    def step(state: TrainState, store_images: Tensor, store_labels: Tensor, idx: Tensor,
             generator: torch.Generator | None = None,
             draws: DeviceStepDraws | None = None) -> dict[str, Tensor]:
        idx = idx.to(store_images.device, torch.long)
        images = store_images.index_select(0, idx).float() / 255.0
        labels = store_labels.index_select(0, idx)
        if draws is None:
            if generator is None:
                raise ValueError("the train step needs a torch.Generator or explicit draws")
            _, H, W, _ = store_images.shape
            draws = sample_draws(generator, idx.shape[0], H, W)
        images = crop_resize_flip(images, *draws.rrc, crop_size)
        return inner(state, images, labels, generator, draws.step)

    step.sample_draws = sample_draws
    return step


def make_eval_step(compute_dtype: torch.dtype = torch.float32):
    """Mask-aware eval step: rows with ``label < 0`` are padding and are left
    out of loss and accuracy; ``count`` is the number of real rows."""

    @torch.no_grad()
    def eval_step(state: TrainState, images: Tensor, labels: Tensor) -> dict[str, Tensor]:
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        logits = state.model(images.to(compute_dtype), train=False)
        labels = labels.to(logits.device)
        valid = (labels >= 0).float()
        count = valid.sum()
        safe = torch.clamp(count, min=1.0)
        log_probs = torch.log_softmax(logits, dim=-1)
        nll = -log_probs.gather(-1, labels.clamp(min=0)[:, None].long())[:, 0]
        top5 = logits.topk(5, dim=-1).indices
        return {
            "loss": (nll * valid).sum() / safe,
            "acc": ((logits.argmax(dim=-1) == labels) * valid).sum() / safe,
            "acc5": ((top5 == labels[:, None]).any(dim=-1) * valid).sum() / safe,
            "count": count,
        }

    return eval_step


def make_eval_accumulate_step(compute_dtype: torch.dtype = torch.float32):
    """Eval step that folds its metrics into an accumulator on the device:
    ``acc`` is a (4,) float32 vector [loss_sum, correct, correct_top5,
    count] (count-weighted sums, so a padded ragged batch adds exactly its
    real rows); the trainer reads it back once per val epoch."""
    eval_step = make_eval_step(compute_dtype)

    @torch.no_grad()
    def accumulate_step(state: TrainState, images: Tensor, labels: Tensor,
                        acc: Tensor) -> Tensor:
        m = eval_step(state, images, labels)
        return acc + torch.stack([m["loss"] * m["count"], m["acc"] * m["count"],
                                  m["acc5"] * m["count"], m["count"]])

    return accumulate_step
