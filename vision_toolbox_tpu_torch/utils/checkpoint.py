"""Checkpoint save/restore and backbone export — port of
``vision_toolbox_tpu/utils/checkpoint.py``.

Replaces the reference's formats (SURVEY.md §5.4):
  (a) Lightning .ckpt → ``save_train_state``: ``torch.save`` of the model's
      state dict (parameters and BatchNorm buffers), the optimizer's state
      (momentum buffers, Adam moments, the accumulation buffers) and the
      step, under ``<dir>/step_<n>/state.pt``, with ``vtt_meta.json`` beside
      it;
  (b) backbone-only .pth with sha-suffix naming (extras.py:112-128) →
      ``extract_backbone`` + ``save_params_pth`` (``{name}-{sha256[:8]}.pth``
      of the backbone's state dict, the ``backbone.`` prefix stripped as the
      reference strips ``model.0.``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Any

import torch

STATE_FILE = "state.pt"
META_FILE = "vtt_meta.json"


def save_train_state(ckpt_dir: str, state: Any, step: int | None = None,
                     meta: dict | None = None) -> str:
    """Save ``state`` (a ``TrainState``: model, optimizer, step) under
    ``ckpt_dir`` (``step_<step>/`` when ``step`` is given) and return the path.

    ``meta`` (a JSON-able dict, e.g. {"grad_accum_steps": k}) is written
    beside it so that a resume fails loudly when the optimizer state's
    structure depends on a config value that changed."""
    path = os.path.abspath(ckpt_dir)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "step": int(state.step)}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))  # no torn checkpoint on preemption
    if meta:
        with open(os.path.join(path, META_FILE), "w") as f:
            json.dump(meta, f)
    return path


def restore_train_state(ckpt_path: str, state: Any, expect_meta: dict | None = None) -> Any:
    """Load a ``save_train_state`` checkpoint into ``state`` (built the same
    way as at save time), onto its model's device, and return it.

    ``expect_meta`` is checked against the saved meta before anything is
    loaded, turning a structural mismatch (e.g. a changed
    ``train.grad_accum_steps``) into a clear error."""
    path = os.path.abspath(ckpt_path)
    if expect_meta:
        meta_path = os.path.join(path, META_FILE)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                saved = json.load(f)
            for k, want in expect_meta.items():
                if k in saved and saved[k] != want:
                    raise ValueError(
                        f"checkpoint {ckpt_path} was saved with {k}={saved[k]} "
                        f"but the current config has {k}={want}; the optimizer "
                        f"state structure depends on it — resume with the same "
                        f"value (or restart without runtime.resume)"
                    )
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def extract_backbone(model: torch.nn.Module, backbone_name: str = "backbone") -> dict:
    """The backbone's part of a classifier's state dict, its prefix stripped
    (the reference strips 'model.0.', extras.py:117-119)."""
    prefix = backbone_name + "."
    return {k[len(prefix):]: v for k, v in model.state_dict().items() if k.startswith(prefix)}


def save_params_pth(state_dict: dict, save_name: str, save_dir: str | None = None) -> str:
    """sha256-named ``.pth`` export of a state dict (extras.py:121-128
    naming: ``{name}-{sha256[:8]}.pth``)."""
    save_dir = save_dir or os.getcwd()
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, buf)
    data = buf.getvalue()
    digest = hashlib.sha256(data).hexdigest()[:8]
    path = os.path.join(save_dir, f"{save_name}-{digest}.pth")
    with open(path, "wb") as f:
        f.write(data)
    return path


def load_params_pth(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)
