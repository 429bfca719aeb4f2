"""``.pth`` reader — port of ``vision_toolbox_tpu/utils/torch_pth.py``.

``load_pth`` returns what the JAX package's torch-free reader returns: the
checkpoint's object graph with every tensor as a C-contiguous numpy array
(bf16 widened to f32, parameters detached, a 0-d tensor a numpy scalar)
and every mapping as a plain dict. It reads
with ``torch.load(weights_only=True)``, so a checkpoint that pickles any
other global (a training script's ``argparse.Namespace``, a model object)
raises ``pickle.UnpicklingError``, as the JAX reader refuses every global it
does not know; the set of allowed globals is torch's own and is not widened.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch


def _to_numpy(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()  # exact: bf16 is the high half of an f32
        return t.numpy()[()] if t.dim() == 0 else t.contiguous().numpy()
    if isinstance(obj, Mapping):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def load_pth(path: str) -> Any:
    """Load a ``torch.save`` file into plain python/numpy objects."""
    return _to_numpy(torch.load(path, map_location="cpu", weights_only=True))
