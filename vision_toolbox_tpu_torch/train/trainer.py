"""Trainer: the full fit loop replacing Lightning's Trainer + callbacks
(SURVEY.md §2.2) — port of ``vision_toolbox_tpu/train/trainer.py``, on one
device. One object wires model, data, the train and eval steps, metrics
logging (JSONL + stdout), per-epoch checkpoints with best-val/acc tracking,
and resume.

The port's choices:
- ``device`` defaults to the card ("cuda") and raises without one; the
  tests pass "cpu".
- Host batches reach the card through ``data.loader.prefetch_to_device``
  (page-locked buffers, copies on a side stream); with
  ``data.device_resident`` the whole uint8 train set is placed on the card
  once and a step receives only its (B,) index vector.
- The random draws of step n come from a ``torch.Generator`` seeded from
  ``(train.seed + 1, n)`` (``step_generator``), as the JAX step folds its
  step count into its key: a resumed run draws what an unbroken run draws,
  and no generator state is checkpointed.
- ``metrics.jsonl`` is truncated on a fresh start and appended to only when
  ``runtime.resume`` is set.
- Parallel configurations (a ``pipe`` or ``model`` mesh axis, a data axis
  over several devices, ``param_sharding`` tp/fsdp, a ``torch.distributed``
  world above 1) raise ``NotImplementedError``: they are not ported.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import time
from typing import Iterator

import numpy as np
import torch

from ..models.base import create_backbone
from ..ops import _cuda
from .classifier import ImageClassifier
from .config import Config, _to_dict, save_config
from .optim import MultiSteps, make_optimizer, warmup_cosine_schedule
from .step import (
    TrainState,
    make_device_data_train_step,
    make_eval_accumulate_step,
    make_train_step,
)
from .tracking import make_tracker

NOT_PORTED = "not ported (ROADMAP Queue 1 item 12: the parallel axes)"


class SyntheticData:
    """Random-data stand-in for smoke runs and benches (data.synthetic=true)."""

    def __init__(self, batch_size: int, crop: int, num_classes: int, steps: int):
        self.batch_size, self.crop, self.num_classes, self.steps = batch_size, crop, num_classes, steps
        rng = np.random.default_rng(0)
        self._images = rng.random((batch_size, crop, crop, 3), np.float32)
        self._labels = rng.integers(0, num_classes, batch_size).astype(np.int32)

    def __len__(self):
        return self.steps

    def __iter__(self) -> Iterator:
        for _ in range(self.steps):
            yield self._images, self._labels


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _refuse_parallel(cfg: Config) -> None:
    """Raise for every configuration that would need more than one device."""
    rt = cfg.runtime
    for axis, size in (rt.mesh_shape or {}).items():
        if int(size) > 1:
            raise NotImplementedError(
                f"runtime.mesh_shape axis {axis!r} of size {size}: {NOT_PORTED}")
    if rt.param_sharding in ("tp", "fsdp"):
        raise NotImplementedError(f"runtime.param_sharding={rt.param_sharding!r}: {NOT_PORTED}")
    if rt.param_sharding != "replicated":
        raise ValueError(f"runtime.param_sharding must be replicated|tp|fsdp, "
                         f"got {rt.param_sharding!r}")
    if _world_size() > 1:
        raise NotImplementedError(
            f"torch.distributed world size {_world_size()}: {NOT_PORTED}")


def _build_backbone(cfg: Config, dtype: torch.dtype, device: torch.device,
                    generator: torch.Generator):
    """The configured backbone with the ``model.drop_out`` / ``drop_path``
    overrides (classifier.py:69-76) passed to the constructor arguments of
    those names that it has. Returns (backbone, the overrides applied)."""
    overrides = {}
    for field_name, value in (("dropout", cfg.model.drop_out),
                              ("stochastic_depth", cfg.model.drop_path),
                              ("drop_path", cfg.model.drop_path)):
        if value is not None:
            overrides[field_name] = value
    while True:
        try:
            backbone = create_backbone(cfg.model.backbone, dtype=dtype, device=device,
                                       generator=generator, **cfg.model.backbone_kwargs,
                                       **overrides)
            return backbone, overrides
        except TypeError as e:  # a constructor without that argument: no such field
            missing = [k for k in overrides if f"unexpected keyword argument '{k}'" in str(e)]
            if not missing:
                raise
            del overrides[missing[0]]


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: a 63-bit word drawn by numpy's
    generator seeded from ``[seed, step]``."""
    return int(np.random.default_rng([seed, step]).integers(2**63))


class Trainer:
    def __init__(self, cfg: Config, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Trainer: device {str(self.device)!r} asked for and no CUDA "
                               "device is available; pass device='cpu' to train on the CPU")
        _refuse_parallel(cfg)
        compute_dtype = torch.bfloat16 if cfg.model.bf16 else torch.float32
        gen = torch.Generator().manual_seed(cfg.train.seed)
        backbone, self.backbone_overrides = _build_backbone(cfg, compute_dtype, self.device, gen)
        self.model = ImageClassifier(backbone, cfg.model.num_classes, dtype=compute_dtype,
                                     generator=gen)

        self._device_store = None
        self.feed = None  # the last epoch's DeviceFeed
        self.train_loader, self.val_loader, self.steps_per_epoch = self._build_data()
        self.steps_per_epoch *= max(1, cfg.data.echo)  # echoes are real optimizer steps

        # gradient accumulation: k micro-batches average into one optimizer
        # step; the schedule advances per OPTIMIZER step, so scale steps/epoch
        # down. linear LR scaling: lr @ batch 1024 (README.md:85)
        self.grad_accum = max(1, cfg.train.grad_accum_steps)
        self.schedule = warmup_cosine_schedule(
            cfg.train.lr, cfg.train.epochs, max(1, -(-self.steps_per_epoch // self.grad_accum)),
            cfg.train.warmup_epochs, cfg.train.warmup_factor, cfg.train.decay_factor,
        )
        opt = make_optimizer(
            cfg.train.optimizer, self.model, self.schedule, momentum=cfg.train.momentum,
            weight_decay=cfg.train.weight_decay, norm_weight_decay=cfg.train.norm_weight_decay,
            bias_weight_decay=cfg.train.bias_weight_decay,
        )
        if self.grad_accum > 1:
            opt = MultiSteps(opt, self.grad_accum)
        self.state = TrainState(self.model, opt)

        step_kwargs = dict(
            label_smoothing=cfg.train.label_smoothing, mixup_alpha=cfg.train.mixup_alpha,
            cutmix_alpha=cfg.train.cutmix_alpha, trivial_augment=cfg.data.trivial_augment,
            random_erasing_p=cfg.data.random_erasing_p, compute_dtype=compute_dtype,
        )
        if self._device_store is not None:
            self.train_step = make_device_data_train_step(
                cfg.model.num_classes, cfg.data.train_crop_size, **step_kwargs)
        else:
            self.train_step = make_train_step(cfg.model.num_classes, **step_kwargs)
        self.eval_step = make_eval_accumulate_step(compute_dtype)

        os.makedirs(cfg.runtime.out_dir, exist_ok=True)
        save_config(cfg, cfg.runtime.out_dir)
        self._log_file = None  # opened at the first record (see _log)
        # optional experiment-tracker mirror (ref configs/base.yaml:25-32 —
        # WandbLogger role); JSONL + stdout stay the source of truth
        self.tracker = make_tracker(cfg.runtime.tracker, cfg.runtime.out_dir, _to_dict(cfg))
        self._tracker_step = 0
        self.best_acc = -1.0

        if cfg.runtime.resume:
            from ..utils.checkpoint import restore_train_state

            restore_train_state(cfg.runtime.resume, self.state, expect_meta=self._meta())
            print(f"resumed from {cfg.runtime.resume} at step {self.state.step}")

    def _meta(self) -> dict:
        return {"grad_accum_steps": self.grad_accum, "optimizer": self.cfg.train.optimizer.lower()}

    # ------------------------------------------------------------------
    @property
    def _local_batch(self) -> int:
        """Per-process rows of the global batch (the reference's per-rank
        batch division, data.py:65-66)."""
        world = _world_size()
        if self.cfg.data.batch_size % world != 0:
            raise ValueError(
                f"data.batch_size={self.cfg.data.batch_size} must be divisible "
                f"by the world size {world}: a silent floor would "
                "shrink the effective global batch while steps_per_epoch and "
                "the lr schedule still assume the configured one"
            )
        return max(1, self.cfg.data.batch_size // world)

    def _build_data(self):
        cfg = self.cfg
        local_bs = self._local_batch
        if cfg.data.synthetic or cfg.data.train_dir is None:
            steps = max(1, cfg.data.train_size // max(cfg.data.batch_size, 1)) if cfg.data.train_size else 10
            train = SyntheticData(local_bs, cfg.data.train_crop_size, cfg.model.num_classes, steps)
            val = SyntheticData(local_bs, cfg.data.val_crop_size, cfg.model.num_classes, 2)
            return train, val, len(train)

        from ..data import DataLoader, ImageFolder, train_transform, val_transform

        if cfg.data.device_resident and not cfg.data.raw_shards:
            raise ValueError(
                "data.device_resident requires data.raw_shards=true "
                "(pre-decode with scripts/make_raw_shards.py or data.raw_shards.write_shard)"
            )
        if cfg.data.raw_shards:
            from ..data.raw_shards import DeviceIndexLoader, RawShardDataset, RawShardLoader

            train_ds = RawShardDataset(cfg.data.train_dir, preload=cfg.data.raw_preload)
            if cfg.data.device_resident:
                images = np.concatenate([np.asarray(s.images) for s in train_ds.shards])
                labels = train_ds._labels_flat
                print(
                    f"device-resident store: {images.nbytes / 1e9:.2f} GB "
                    f"({len(images)} images @ {train_ds.h}px) -> {self.device}, one-time"
                )
                self._device_store = (
                    torch.from_numpy(images).to(self.device),
                    torch.from_numpy(labels.astype(np.int32)).to(self.device),
                )
                train = DeviceIndexLoader(len(images), labels, local_bs, seed=cfg.train.seed)
            else:
                train = RawShardLoader(
                    train_ds, local_bs, cfg.data.train_crop_size,
                    training=True, seed=cfg.train.seed,
                )
            val = None
            if cfg.data.val_dir:
                val_ds = RawShardDataset(cfg.data.val_dir, preload=cfg.data.raw_preload)
                val = RawShardLoader(
                    val_ds, local_bs, min(cfg.data.val_crop_size, val_ds.h), training=False,
                )
            return train, val, len(train)

        if cfg.data.webdataset:
            import glob

            from ..data.wds_loader import WebDatasetLoader

            train_shards = sorted(glob.glob(cfg.data.train_dir))
            val_shards = sorted(glob.glob(cfg.data.val_dir)) if cfg.data.val_dir else []
            num_batches = (
                cfg.data.train_size // cfg.data.batch_size if cfg.data.train_size else None
            )
            train = WebDatasetLoader(
                train_shards, local_bs,
                transform=lambda r, im: train_transform(r, im, cfg.data.train_crop_size),
                training=True, num_batches=num_batches, seed=cfg.train.seed,
                num_streams=cfg.data.num_workers,  # ref num_workers: 8 (base.yaml)
            )
            val = (
                WebDatasetLoader(
                    val_shards, local_bs,
                    transform=lambda r, im: val_transform(
                        im, cfg.data.val_resize_size, cfg.data.val_crop_size
                    ),
                    training=False,
                    num_batches=(cfg.data.val_size // cfg.data.batch_size) or None
                    if cfg.data.val_size
                    else None,
                    num_streams=cfg.data.num_workers,
                )
                if val_shards
                else None
            )
            steps = num_batches if num_batches else 1
            return train, val, steps

        train_ds = ImageFolder(cfg.data.train_dir)
        val_ds = ImageFolder(cfg.data.val_dir) if cfg.data.val_dir else None
        if cfg.data.native_decode:
            from ..data.native import NativeJPEGLoader, native_available

            if not native_available():
                raise RuntimeError("data.native_decode=true but native/libvttdata.so "
                                   "is unavailable (run `make -C native`)")
            train = NativeJPEGLoader(
                train_ds, local_bs, cfg.data.train_crop_size,
                num_threads=cfg.data.num_workers, seed=cfg.train.seed,
            )
        else:
            train = DataLoader(
                train_ds, local_bs,
                transform=lambda r, im: train_transform(r, im, cfg.data.train_crop_size),
                shuffle=True, drop_last=True, num_workers=cfg.data.num_workers,
                seed=cfg.train.seed,
            )
        val = (
            DataLoader(
                val_ds, local_bs,
                transform=lambda r, im: val_transform(
                    im, cfg.data.val_resize_size, cfg.data.val_crop_size
                ),
                num_workers=cfg.data.num_workers,
            )
            if val_ds
            else None
        )
        return train, val, len(train)

    # ------------------------------------------------------------------
    def _log(self, record: dict):
        if self._log_file is None:
            # a fresh start truncates the log; only a resume appends to it
            mode = "a" if self.cfg.runtime.resume else "w"
            self._log_file = open(os.path.join(self.cfg.runtime.out_dir, "metrics.jsonl"), mode)
        record = {k: (float(v) if hasattr(v, "item") else v) for k, v in record.items()}
        self._log_file.write(json.dumps(record) + "\n")
        self._log_file.flush()
        if "step" in record:
            self._tracker_step = int(record["step"])
        self.tracker.log(record, self._tracker_step)
        print("  ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in record.items()))

    def step_generator(self, step: int) -> torch.Generator:
        """The generator of train step ``step``, seeded from
        ``(train.seed + 1, step)``."""
        return torch.Generator(device=self.device).manual_seed(
            step_seed(self.cfg.train.seed + 1, step))

    def train_batch(self, batch: tuple) -> dict[str, torch.Tensor]:
        """The train step(s) of one fed batch: ``data.echo`` steps, each with
        its own step's draws. ``batch`` is (images, labels) on the device,
        or (idx,) with the device-resident store."""
        for _ in range(max(1, self.cfg.data.echo)):
            g = self.step_generator(self.state.step)
            if self._device_store is not None:
                metrics = self.train_step(self.state, *self._device_store, batch[0], g)
            else:
                metrics = self.train_step(self.state, batch[0], batch[1], g)
        return metrics

    def _train_feed(self):
        """The fed batches of one epoch: the loader's through
        ``prefetch_to_device``; with the device-resident store only the index
        vectors cross to the device."""
        from ..data.loader import prefetch_to_device

        batches = iter(self.train_loader)
        if self._device_store is not None:
            batches = ((idx,) for idx, _ in batches)
        self.feed = prefetch_to_device(batches, self.device)
        return self.feed

    def fit(self):
        # Preemption-safe: SIGTERM/SIGINT request a checkpoint at the next
        # step boundary instead of dying mid-epoch (resume with
        # runtime.resume=<ckpt>); the handlers are restored afterwards.
        self._preempted = False

        def _request_stop(signum, frame):
            self._preempted = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # not in the main thread
                pass

        self._profiler, self._profiled = None, False
        try:
            return self._fit_loop(self.cfg)
        finally:
            # a trace still open when training ended (or was preempted) is
            # closed, or it would be left open
            if self._profiler is not None:
                self._profiler.stop()
                self._profiler = None
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            self.tracker.finish()

    def _profile(self, step: int) -> None:
        """``runtime.profile_steps``: a torch.profiler trace of that many
        steps from step 2 (past the first steps' kernel builds and cuDNN
        choices), written to <out_dir>/profile/trace.json."""
        n = self.cfg.runtime.profile_steps
        if not n:
            return
        if step == 2 and not self._profiled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
            self._profiled = True
        elif step == 2 + n and self._profiler is not None:
            self._profiler.stop()
            path = os.path.join(self.cfg.runtime.out_dir, "profile", "trace.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._profiler.export_chrome_trace(path)
            self._profiler = None
            self._log({"profile_trace": path})

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fit_loop(self, cfg):
        # Resume continues the epoch count from the restored step (the
        # reference gets this from Lightning's `fit(ckpt_path=...)`). A
        # mid-epoch preemption checkpoint restarts its epoch from the top.
        start_epoch = min(self.state.step // max(1, self.steps_per_epoch), cfg.train.epochs)
        for epoch in range(start_epoch, cfg.train.epochs):
            launches = dict(_cuda.LAUNCHES)
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            t0 = time.time()
            n_images = 0
            for batch in self._train_feed():
                self._profile(self.state.step)
                metrics = self.train_batch(batch)
                n_images += batch[0].shape[0]
                step = self.state.step
                if self._preempted:
                    path = self.save(epoch)
                    self._log({"preempted_at_step": step, "checkpoint": path})
                    return self.state
                if step % cfg.runtime.log_every == 0:
                    self._log(
                        {
                            "epoch": epoch,
                            "step": step,
                            "train/loss": metrics["loss"],
                            # lr actually applied at micro-step `step` (the
                            # optimizer's schedule count is the number of
                            # completed optimizer updates BEFORE that step)
                            "lr": float(self.schedule((step - 1) // self.grad_accum)),
                        }
                    )
            self._sync()
            dt = time.time() - t0
            record = {"epoch": epoch, "epoch_time_s": dt, "train_ips": n_images / dt}
            if self.device.type == "cuda":
                record["peak_memory_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
            # the hand-written kernels this epoch's steps launched
            record.update({f"launches/{k}": n - launches[k] for k, n in _cuda.LAUNCHES.items()
                           if n != launches[k]})

            if self.val_loader is not None:
                record.update(self.evaluate())
            self._log(record)

            if (epoch + 1) % cfg.runtime.checkpoint_every_epochs == 0:
                self.save(epoch, record.get("val/acc"))
        return self.state

    def evaluate(self) -> dict:
        if self.val_loader is None:
            # reference CLI degrades gracefully without val data (Lightning)
            print("evaluate: no validation data configured (data.val_dir unset)")
            return {}
        # device-side accumulator [loss_sum, correct, correct5, count]: the
        # whole val epoch runs with no host sync, ONE readback at the end
        acc = torch.zeros((4,), dtype=torch.float32, device=self.device)
        for images, labels in self._val_batches():
            acc = self.eval_step(self.state, images, labels, acc)
        loss_sum, acc_sum, acc5_sum, total = acc.tolist()
        if total == 0:
            return {}
        return {
            "val/loss": loss_sum / total,
            "val/acc": acc_sum / total,
            "val/acc5": acc5_sum / total,
        }

    def _val_batches(self):
        """Yield (padded) val batches on the device; keep them there when small.

        The val set is deterministic (centre crop, fixed order), so after the
        first val epoch the padded device tensors are reused as they are; the
        per-epoch host->device copy would be pure waste. Capped by
        runtime.cache_val_limit_mb so ImageNet-scale val sets stream.
        """
        cached = getattr(self, "_val_cache", None)
        if cached is not None and cached[0] is self.val_loader:
            yield from cached[1]
            return
        from ..data.loader import prefetch_to_device

        rt = self.cfg.runtime
        collect = rt.cache_val_on_device
        budget = rt.cache_val_limit_mb * 1e6
        batches = []
        nominal = self._local_batch

        def padded():
            for images, labels in self.val_loader:
                images, labels = np.asarray(images), np.asarray(labels, np.int32)
                b = images.shape[0]
                if b != nominal:
                    # pad the ragged final batch to the nominal shape; label -1
                    # marks padding, which the mask-aware eval step excludes
                    images = np.concatenate(
                        [images, np.zeros((nominal - b, *images.shape[1:]), images.dtype)])
                    labels = np.concatenate([labels, np.full((nominal - b,), -1, np.int32)])
                yield images, labels

        for images, labels in prefetch_to_device(padded(), self.device):
            if collect:
                batches.append((images, labels))
                if sum(im.nbytes for im, _ in batches) > budget:
                    collect, batches = False, []
            yield images, labels
        if collect and batches:
            # keyed to the loader object: swapping val_loader (or rebuilding
            # it at a new batch size) invalidates the cache
            self._val_cache = (self.val_loader, batches)

    def save(self, epoch: int, val_acc: float | None = None):
        from ..utils.checkpoint import save_train_state

        path = save_train_state(
            os.path.join(self.cfg.runtime.out_dir, "checkpoints"), self.state,
            step=self.state.step, meta=self._meta(),
        )
        # ModelCheckpoint(monitor=val/acc, mode=max) equivalent (configs/base.yaml:33-36)
        if val_acc is not None and val_acc > self.best_acc:
            self.best_acc = val_acc
            best = os.path.join(self.cfg.runtime.out_dir, "best")
            if os.path.isdir(best):
                shutil.rmtree(best)
            shutil.copytree(path, best)
        return path
