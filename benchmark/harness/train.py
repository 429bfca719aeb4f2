"""A train cell: the recipe's ``Trainer`` on a seeded device-resident store.

Set-up writes a store of seeded uint8 images as a raw shard under the
temporary directory, builds the ``Trainer`` from the configuration's recipe
(it loads the shard into device memory, ``data.device_resident``), loads
the benchmark's seeded weights into its model and drives the first steps
through the trainer's own feed and ``train_batch``, reading the loss of each,
the first gradient (from SGD's momentum buffer after one update) and the
parameters' change after them. The window then drives the same object on:
every step's images over the window's time, which ends with a
synchronize. The plain reference follows the first steps once the window
has closed and the program's state is freed.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from ..reference import models as ref_models
from ..reference import train as ref_train
from . import compare, trace, weights


def _config(recipe: dict, batch: int, seed: int, train_dir: str, out_dir: str):
    from vision_toolbox_tpu_torch.train.config import Config

    cfg = Config()
    for section, values in recipe.items():
        for key, value in values.items():
            setattr(getattr(cfg, section), key, value)
    cfg.data.batch_size, cfg.train.seed = batch, seed
    cfg.data.train_dir, cfg.data.val_dir = train_dir, None
    cfg.data.raw_shards = cfg.data.device_resident = cfg.data.raw_preload = True
    cfg.runtime.out_dir, cfg.runtime.log_every = out_dir, 10**9
    return cfg


def _norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


class Steps:
    """The trainer's epochs of fed batches, one after another."""

    def __init__(self, trainer):
        self.trainer, self.batches = trainer, iter(())

    def next(self):
        for _ in range(2):
            batch = next(self.batches, None)
            if batch is not None:
                return batch
            self.batches = iter(self.trainer._train_feed())
        raise RuntimeError("the trainer's feed yields no batch")


def first_steps(trainer, steps: Steps, w0: dict, n: int) -> tuple[dict, list[torch.Tensor]]:
    """Run ``n`` steps; read their losses, the first gradient and the
    parameters' change. Returns (readings, the steps' index vectors)."""
    model, opt = trainer.state.model, trainer.state.optimizer
    names = {id(p): k for k, p in model.named_parameters()}
    losses, idx, grads = [], [], {}
    for i in range(n):
        batch = steps.next()
        idx.append(batch[0].cpu())
        losses.append(float(trainer.train_batch(batch)["loss"]))
        if i == 0:
            # SGD's buffer after one update is g + wd·p0 (p0 the weights given)
            bufs = opt.buffers or [None] * len(opt.groups)
            for (wd, ps), group in zip(opt.groups, bufs):
                for j, p in enumerate(ps):
                    b = torch.zeros_like(p) if group is None else group[j]
                    grads[names[id(p)]] = b - wd * w0[names[id(p)]] if wd else b
            grads = _norms(grads)
    change = _norms({k: p.detach() - w0[k] for k, p in model.named_parameters()})
    return {"losses": losses, "grad_norms": grads, "change_norms": change}, idx


def run(cell, seed: int, seconds: float, do_trace: bool, dev, t_start: float,
        fault: str | None = None) -> dict:
    from vision_toolbox_tpu_torch.data.raw_shards import write_shard
    from vision_toolbox_tpu_torch.train.trainer import Trainer

    device, sync = dev.device, dev.sync
    cfg_file, traffic = cell.config, cell.traffic
    arch, recipe = cfg_file["architecture"], cfg_file["recipe"]
    batch = cfg_file["batch_size"]
    crop = recipe["data"]["train_crop_size"]
    # the store: seeded images, written as the trainer's raw shard format
    store = weights.images(seed, weights.STORE, traffic["store_images"], cfg_file["store_px"],
                           device).cpu()
    g = np.random.default_rng(weights.sub_seed(seed, weights.STORE))
    labels = torch.from_numpy(g.integers(0, arch["num_classes"], len(store)).astype(np.int32))
    with tempfile.TemporaryDirectory(prefix="vtt-bench-") as tmp:
        os.makedirs(os.path.join(tmp, "train"))
        write_shard(os.path.join(tmp, "train", "store_000.vtraw"), store.numpy(), labels.numpy())
        cfg = _config(recipe, batch, seed, os.path.join(tmp, "train"), os.path.join(tmp, "out"))
        trainer = Trainer(cfg, device=device)
    ref_meta = ref_models.build(arch, classifier=True, device="meta")
    w0 = weights.make(ref_meta, seed, device)
    weights.load(trainer.state.model, w0)
    if fault == "frozen_state":
        trainer.state.optimizer.step = lambda: None
    elif fault == "half_batch":
        inner = trainer.train_step
        trainer.train_step = lambda state, images, labels, idx, g: inner(
            state, images, labels, idx[: len(idx) // 2], g)
    steps = Steps(trainer)
    prog, idx = first_steps(trainer, steps, w0, traffic["checked_steps"])
    del w0
    for _ in range(traffic["warmup_steps"]):
        trainer.train_batch(steps.next())
    sync()
    setup_peak = dev.peak()
    dev.reset_peak()
    setup_s = time.perf_counter() - t_start

    # the window
    n_steps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        trainer.train_batch(steps.next())
        n_steps += 1
    sync()
    window_s = time.perf_counter() - t0
    window_peak = dev.peak()
    out = {"arch": arch, "setup_s": setup_s, "window_s": window_s, "steps": n_steps,
           "batch": batch, "images": n_steps * batch, "peak_bytes": window_peak}

    if do_trace:
        out["trace"] = _traced(trainer, steps, traffic["profiled_steps"], sync)
    out["memory_peak_bytes"] = max(setup_peak, window_peak, dev.peak())

    # the reference, once the program's state is freed
    steps_per_epoch = trainer.steps_per_epoch
    del trainer, steps
    dev.free()
    ref = reference(arch, recipe, seed, store, labels, idx, steps_per_epoch, device)
    out["numbers"] = compare.train_numbers(prog, ref)
    out["readings"] = prog, ref
    out["flops_per_image"] = 3 * _forward_flops(arch, crop)
    return out


def _traced(trainer, steps: Steps, n: int, sync) -> trace.Trace:
    """Profile ``n`` more steps with ``bench:`` ranges around the model,
    its blocks, the optimizer's update and the whole step."""
    from vision_toolbox_tpu_torch.nn.attention import ViTBlock

    ranges, model, opt = trace.Ranges(), trainer.state.model, trainer.state.optimizer
    ranges.add(model, "model")
    for m in model.modules():
        if isinstance(m, ViTBlock):
            ranges.add(m, "blocks")
    opt_step = opt.step

    def optim_step():
        with trace.named("optim"):
            opt_step()

    def one_step():
        batch = steps.next()
        with trace.named("step"):
            trainer.train_batch(batch)

    opt.step = optim_step
    try:
        return trace.profile(one_step, n, sync)
    finally:
        ranges.close()
        del opt.step  # the instance attribute: the class's method again


def reference(arch: dict, recipe: dict, seed: int, store: torch.Tensor, labels: torch.Tensor,
              idx: list[torch.Tensor], steps_per_epoch: int, device: torch.device,
              fp8: bool = False) -> dict:
    """The plain reference's readings of the same steps, in f32 (TF32 off)
    or, for the control, with float8 products."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = ref_models.build(arch, classifier=True, device=device, fp8=fp8)
        weights.load(model, weights.make(model, seed, device))
        recipe = {**recipe, "train": {**recipe["train"], "seed": seed}}
        return ref_train.run(model, store.to(device), labels.to(device), idx, recipe,
                             steps_per_epoch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _forward_flops(arch: dict, size: int) -> int:
    from .flops import forward_flops

    return forward_flops(ref_models.build(arch, classifier=True, device="meta"),
                         (1, size, size, 3))

