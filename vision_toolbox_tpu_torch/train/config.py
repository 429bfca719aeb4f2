"""Config system: dataclasses + YAML composition — port of
``vision_toolbox_tpu/train/config.py``, field for field, so that the port
reads the repo's ``configs/*.yaml`` as they are.

Mirrors the reference's LightningCLI contract (SURVEY.md §5.6): every field is
a flag, later ``--config`` files override earlier ones, dotted CLI overrides
(``--set train.lr=0.1``) beat files, and the final merged config is archived
next to the checkpoints as ``saved_config.yaml``. The parallel fields
(``mesh_shape`` with a ``pipe`` or ``model`` axis, ``param_sharding`` tp/fsdp,
the pipeline's) still parse; the port's trainer refuses them
(``train/trainer.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelConfig:
    backbone: str = "vovnet57"
    num_classes: int = 1000
    backbone_kwargs: dict = field(default_factory=dict)
    bf16: bool = True  # reference trains fp16 AMP (configs/base.yaml:20); the port uses bf16
    # post-hoc overrides mirroring classifier.py:69-76's module walk: applied
    # to the backbone's dropout / stochastic-depth fields when it has them
    drop_out: float | None = None
    drop_path: float | None = None


@dataclass
class DataConfig:
    train_dir: str | None = None
    val_dir: str | None = None
    batch_size: int = 128  # global batch
    num_workers: int = 8
    train_crop_size: int = 176
    val_resize_size: int = 232
    val_crop_size: int = 224
    webdataset: bool = False
    train_size: int = 0
    val_size: int = 0
    random_erasing_p: float = 0.1
    trivial_augment: bool = True
    synthetic: bool = False  # random data for smoke runs/benchmarks
    native_decode: bool = False  # C++ libjpeg decode path (native/decoder.cpp)
    # pre-decoded raw-crop shards (data/raw_shards.py, scripts/make_raw_shards.py):
    # train_dir/val_dir point at .vtraw shard dirs; host "decode" is a memmap
    # copy + random-window crop — the few-core-host escape hatch.
    raw_shards: bool = False
    # with raw_shards: place the whole decoded train set in HBM once and run
    # RandomResizedCrop+flip on device (ops/device_rrc.py); per-step H2D
    # traffic drops to a (B,) index vector. Requires the store to fit in
    # device memory next to the model (uint8: N*S*S*3 bytes). Single-process only.
    device_resident: bool = False
    # read whole shards into RAM at startup (one sequential pass) instead of
    # paying cold random memmap faults in epoch 0; use when corpus < RAM.
    raw_preload: bool = True
    # data echoing (arxiv 1907.05550): run N optimizer steps per host batch —
    # the device-side augmentation re-randomizes each step, so echoes see
    # different TrivialAugment/RandomErasing/CutMix draws. Use when the input
    # pipeline, not the card, is the bottleneck.
    echo: int = 1


@dataclass
class TrainConfig:
    epochs: int = 100
    optimizer: str = "sgd"  # sgd | rmsprop | adamw | lamb | lars
    lr: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 2e-5
    norm_weight_decay: float = 0.0
    bias_weight_decay: float = 0.0
    label_smoothing: float = 0.1
    mixup_alpha: float = 0.2
    cutmix_alpha: float = 1.0
    warmup_epochs: int = 5
    warmup_factor: float = 0.01
    decay_factor: float = 0.0
    seed: int = 0
    # average k micro-batch gradients into one optimizer step (optax
    # MultiSteps); effective batch = batch_size * k. BN statistics still
    # update per micro-batch (standard accumulation semantics).
    grad_accum_steps: int = 1


@dataclass
class RuntimeConfig:
    out_dir: str = "runs/default"
    log_every: int = 50
    checkpoint_every_epochs: int = 1
    resume: str | None = None
    mesh_axes: tuple[str, ...] = ("data",)
    # explicit mesh layout, e.g. {"data": 4, "model": 2}; None = 1-D data mesh
    # over all devices (mesh_axes). Axis-size product must equal device count.
    mesh_shape: dict | None = None
    # parameter placement: "replicated" (DDP-style), "tp" (big 2-D kernels
    # column-sharded over the "model" axis), or "fsdp" (ZeRO-3: every large
    # param sharded over the data axis, all-gathered at use)
    param_sharding: str = "replicated"
    sharding_min_size: int = 65536  # params smaller than this stay replicated
    profile_steps: int = 0  # capture a torch.profiler trace of N train steps
    # keep the (padded, sharded) val batches device-resident after the first
    # val epoch, skipping the per-epoch host->device re-transfer. Worth it
    # whenever the val set is small vs device memory (3k images @224 = 451 MB);
    # the limit caps the cached bytes — larger val sets stream as before.
    cache_val_on_device: bool = True
    cache_val_limit_mb: int = 2048
    tracker: str = "none"  # none | tensorboard | wandb (train/tracking.py)
    # pipeline parallelism (parallel/pipeline.py): enabled when mesh_shape
    # has a "pipe" axis > 1 (e.g. {"data": 2, "pipe": 4}); requires a
    # stacked-transformer backbone (ViT/DeiT/DeiT3/CaiT/Mixer) with
    # dropout/drop_path 0. 0 microbatches = auto (largest of 4S/2S/S that
    # divides the batch).
    pipeline_microbatches: int = 0
    pipeline_remat: bool = False  # checkpoint each layer (GPipe memory lever)
    # Megatron-style interleaved schedule: each device holds `interleave`
    # non-contiguous layer chunks, shrinking the bubble at FIXED microbatch
    # count/memory (needs depth % (pipe*interleave) == 0, microbatches <= pipe)
    pipeline_interleave: int = 1


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


def _merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _to_dict(cfg: Any) -> dict:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg


def _from_dict(cls, d: dict):
    import typing

    hints = typing.get_type_hints(cls)  # resolves string annotations
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = _from_dict(ftype, v)
        elif f.name == "mesh_axes" and isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def load_config(config_paths: list[str], overrides: list[str] | None = None) -> Config:
    """Compose YAML files (later overrides earlier) + dotted CLI overrides."""
    import yaml

    merged: dict = _to_dict(Config())
    for path in config_paths:
        with open(path) as fobj:
            _merge(merged, yaml.safe_load(fobj) or {})
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = merged
        parts = key.lstrip("-").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return _from_dict(Config, merged)


def save_config(cfg: Config, out_dir: str) -> str:
    import yaml

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "saved_config.yaml")
    with open(path, "w") as fobj:
        yaml.safe_dump(_to_dict(cfg), fobj, sort_keys=False)
    return path
