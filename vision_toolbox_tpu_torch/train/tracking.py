"""Experiment-tracker sinks behind the trainer's JSONL logging — port of
``vision_toolbox_tpu/train/tracking.py``.

The reference logs every run to Wandb with an LR monitor and model upload
(reference configs/base.yaml:25-32, vision_toolbox uses Lightning's
WandbLogger).  Here the JSONL file + stdout remain the source of truth
(they feed the committed run artifacts); a tracker is an OPTIONAL mirror
selected by ``runtime.tracker``:

- ``none``        — no-op (default)
- ``tensorboard`` — event files under <out_dir>/tb via tensorboardX
- ``wandb``       — wandb.log, gated on the package being importable
  (not installed in offline environments; construction raises a clear
  error instead of silently dropping records)

Only scalar values are forwarded; non-numeric record fields (paths,
messages) stay JSONL-only.
"""

from __future__ import annotations

from typing import Protocol


class Tracker(Protocol):
    def log(self, record: dict, step: int) -> None: ...
    def finish(self) -> None: ...


class NoopTracker:
    def log(self, record: dict, step: int) -> None:
        pass

    def finish(self) -> None:
        pass


def _scalars(record: dict) -> dict:
    out = {}
    for k, v in record.items():
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            out[k] = float(v)
        elif hasattr(v, "item") and getattr(v, "size", 1) == 1:
            out[k] = float(v)
    return out


class TensorBoardTracker:
    """Scalar mirror into TF event files (tensorboardX, no TF dependency)."""

    def __init__(self, out_dir: str, config: dict | None = None):
        import os

        try:
            from tensorboardX import SummaryWriter
        except ImportError as e:  # pragma: no cover - environment-dependent
            raise RuntimeError(
                "runtime.tracker='tensorboard' but the tensorboardX package "
                "is not installed; use tracker='wandb' or 'none'"
            ) from e

        self._w = SummaryWriter(os.path.join(out_dir, "tb"))
        if config:
            import json

            self._w.add_text("config", "```\n" + json.dumps(config, indent=2, default=str) + "\n```")

    def log(self, record: dict, step: int) -> None:
        for k, v in _scalars(record).items():
            self._w.add_scalar(k, v, step)

    def finish(self) -> None:
        self._w.close()


class WandbTracker:
    def __init__(self, out_dir: str, config: dict | None = None, **init_kwargs):
        try:
            import wandb
        except ImportError as e:  # pragma: no cover - environment-dependent
            raise RuntimeError(
                "runtime.tracker='wandb' but the wandb package is not "
                "installed; use tracker='tensorboard' or 'none'"
            ) from e
        self._run = wandb.init(dir=out_dir, config=config, **init_kwargs)

    def log(self, record: dict, step: int) -> None:
        self._run.log(_scalars(record), step=step)

    def finish(self) -> None:
        self._run.finish()


def make_tracker(kind: str, out_dir: str, config: dict | None = None) -> Tracker:
    if kind in (None, "none", ""):
        return NoopTracker()
    if kind == "tensorboard":
        return TensorBoardTracker(out_dir, config)
    if kind == "wandb":
        return WandbTracker(out_dir, config)
    raise ValueError(f"runtime.tracker must be none|tensorboard|wandb, got {kind!r}")
