"""Serving export via ``torch.export`` — port of
``vision_toolbox_tpu/utils/export.py``.

``export_model`` traces the inference forward into an ``ExportedProgram``
(weights included) and serialises it to bytes; ``load_exported`` turns the
bytes back into a callable without the model's Python code. The fused
half-blocks appear in the program as the custom ops ``vtt::fused_mlp_block``
and ``vtt::fused_attention_block``, CaiT's talking-head attention as
``vtt::talking_head_attention``, long-sequence attention (SigLIP at 512
px) as ``vtt::flash_attention``, short unbiased attention on the module
chain (a ViT with dropout) as ``vtt::short_attention``, which takes K2's
batch-dependent pair test at run time so the batch stays free, the
depthwise convs (ConvNeXt) as
``vtt::depthwise_conv2d``, and Swin's window attention and shifted-window
relayouts as ``vtt::swin_window_attention``, ``vtt::swin_window_partition``
and ``vtt::swin_window_unpartition``, so the loaded program runs the CUDA kernels
on CUDA inputs and their plain versions on CPU inputs; importing this module
registers them. Every backbone is exported from a copy whose parameters are
stored in its compute type (``Backbone.cast_for_serving``; CaiT's head
mixes stay f32, as its kernels read them), so that a request pays no casts.

A call of the loaded program is a ``serve`` span (``utils/tracing.py``) split
in two: ``serve.prologue`` from the call to the end of the loaded module's
forward pre-hooks (its input-constraint check), ``serve.graph`` from there
to its forward hooks (the input's flattening, the guards, the graph).
"""

from __future__ import annotations

import copy
import io
import threading

import torch

from ..models.base import Backbone
from ..ops import (  # noqa: F401  (registers the custom ops)
    block_attention, block_mlp, cait_attention, depthwise_conv, flash_attention, short_attention,
    swin_attention, swin_relayout,
)
from . import tracing


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


class ServedProgram:
    """A loaded program, called as ``program(x)``; ``module`` is the loaded
    ``torch.export`` module."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self._part = threading.local()  # the serve.* span open in this thread's call
        module.register_forward_pre_hook(self._graph_starts)  # after the module's own
        module.register_forward_hook(self._graph_ends, prepend=True)

    def _switch(self, name: str | None) -> None:
        part = getattr(self._part, "span", None)
        if part is not None:
            part.__exit__(None, None, None)
        self._part.span = None if name is None else tracing.span(name).__enter__()

    def _graph_starts(self, module, args) -> None:
        self._switch("serve.graph")

    def _graph_ends(self, module, args, out) -> None:
        self._switch(None)

    def __call__(self, *args, **kwargs):
        with tracing.span("serve"):
            self._switch("serve.prologue")
            try:
                return self.module(*args, **kwargs)
            finally:
                self._switch(None)


def load_exported(blob: bytes) -> ServedProgram:
    """Deserialise an exported artifact into a callable(x) -> output."""
    return ServedProgram(torch.export.load(io.BytesIO(blob)).module())
