"""Serving export via ``torch.export`` — port of
``vision_toolbox_tpu/utils/export.py``.

``export_model`` traces the inference forward into an ``ExportedProgram``
(weights included) and serialises it to bytes; ``load_exported`` turns the
bytes back into a callable without the model's Python code. The fused
half-blocks appear in the program as the custom ops ``vtt::fused_mlp_block``
and ``vtt::fused_attention_block``, so the loaded program runs the CUDA
kernels on CUDA inputs and their plain versions on CPU inputs; importing this
module registers them. Every backbone is exported from a copy whose
parameters are stored in its compute type (``Backbone.cast_for_serving``),
so that a request pays no casts.
"""

from __future__ import annotations

import copy
import io
from typing import Callable

import torch
from torch import Tensor

from ..models.base import Backbone
from ..ops import block_attention, block_mlp  # noqa: F401  (registers the custom ops)


def export_model(model: Backbone, input_shape: tuple[int, ...],
                 dtype: torch.dtype = torch.float32) -> bytes:
    """Serialise the inference forward ``model(x)`` traced at ``input_shape``
    on the model's device; the batch dimension stays free."""
    device = next(model.parameters()).device
    model = copy.deepcopy(model).cast_for_serving()
    x = torch.zeros(input_shape, dtype=dtype, device=device)
    dynamic = {"x": {0: torch.export.Dim("batch", min=1, max=65535)}}
    with torch.no_grad():
        program = torch.export.export(model, (x,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes) -> Callable[[Tensor], Tensor]:
    """Deserialise an exported artifact into a callable(x) -> output."""
    return torch.export.load(io.BytesIO(blob)).module()
