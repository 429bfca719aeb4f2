"""Model profiling — port of ``vision_toolbox_tpu/utils/profile.py``
(reference extras.py:132-168): parameters (M), forward GFLOPs, forward and
forward+backward ms, device memory.

GFLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which counts
the products of PyTorch's matmul, convolution and attention ops. It sees
nothing inside a custom op, so this module registers a formula for each of
the port's nine ``vtt::`` ops (importing it registers them): 2 × the
multiply-adds of every product the op computes — the same count the
counter gives the op's plain PyTorch version, with the depthwise conv's taps
counted as the grouped convolution that computes them — and 0 for Swin's
relayouts. Count a forward under ``torch.no_grad()`` with the parameters'
``requires_grad`` off (``frozen``): with gradients the kernels are launched
from autograd functions that the counter cannot see, and the counter's
module hooks fail on a module input that is a no-grad view of a parameter
that requires grad (CaiT's cls token, SigLIP's probe).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from ..ops import (  # noqa: F401  (defines the custom ops counted below)
    block_attention, block_mlp, cait_attention, depthwise_conv, flash_attention, short_attention,
    swin_attention, swin_relayout,
)

vtt = torch.ops.vtt


@register_flop_formula(vtt.fused_mlp_block)
def _fused_mlp_flops(x, ln_scale, ln_bias, w1, *args, out_shape=None, **kwargs) -> int:
    """LN(x)·W1ᵀ and GELU(…)·W2ᵀ; w1 (Dh, D)."""
    return 2 * 2 * math.prod(x[:-1]) * w1[0] * w1[1]


@register_flop_formula(vtt.fused_attention_block)
def _fused_attention_flops(x, *args, out_shape=None, **kwargs) -> int:
    """The q, k, v and out projections and the core's q·kᵀ and p·v."""
    B, T, D = x
    return 4 * 2 * B * T * D * D + 2 * 2 * B * T * T * D


@register_flop_formula(vtt.talking_head_attention)
def _talking_head_flops(q, k, v, ml, *args, out_shape=None, **kwargs) -> int:
    """q·kᵀ and p·v over every head, and the two (N, N) head mixes of the
    (B, N, T, S) logits and probabilities."""
    B, T, D = q
    S, N = k[1], ml[0]
    return 2 * 2 * B * T * S * D + 2 * 2 * B * N * N * T * S


@register_flop_formula(vtt.depthwise_conv2d)
def _depthwise_flops(x, w, *args, out_shape=None, **kwargs) -> int:
    """One product a tap: (B, H, W, C) by (k, k, 1, C)."""
    return 2 * math.prod(x) * w[0] * w[1]


@register_flop_formula([vtt.flash_attention, vtt.short_attention])
def _attention_flops(q, k, *args, out_shape=None, **kwargs) -> int:
    """q·kᵀ and p·v; q (B, T, N, H) or flat (B·N, T, H), S = k.shape[1]."""
    return 2 * 2 * math.prod(q) * k[1]


@register_flop_formula(vtt.swin_window_attention)
def _swin_attention_flops(q, k, *args, out_shape=None, **kwargs) -> int:
    """q·kᵀ and p·v in every window; q (B, nW, T, N·hd), S = k.shape[2]."""
    return 2 * 2 * math.prod(q) * k[2]


@register_flop_formula([vtt.swin_window_partition, vtt.swin_window_unpartition])
def _relayout_flops(*args, out_shape=None, **kwargs) -> int:
    return 0


def count_params(model: torch.nn.Module) -> float:
    """Parameter count in millions (BatchNorm statistics are buffers, as
    they are no parameters in the JAX package)."""
    return sum(p.numel() for p in model.parameters()) / 1e6


def device_memory_mb(device: torch.device | str | None = None) -> dict:
    """The card's allocator in MB: in use, peak (since the last
    ``torch.cuda.reset_peak_memory_stats``) and the device's total; ``{}``
    on the CPU, as the JAX function returns on a backend without stats."""
    device = torch.device("cuda" if device is None and torch.cuda.is_available() else
                          device or "cpu")
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "mem_in_use_mb": stats["allocated_bytes.all.current"] / 2**20,
        "mem_peak_mb": stats["allocated_bytes.all.peak"] / 2**20,
        "mem_limit_mb": torch.cuda.mem_get_info(device)[1] / 2**20,
    }


@contextlib.contextmanager
def frozen(model: torch.nn.Module):
    """``model``'s parameters with ``requires_grad`` off inside the block."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield model
    finally:
        for p in params:
            p.requires_grad_(True)


def flops(fn: Callable, *args: Any) -> float:
    """GFLOPs of one call ``fn(*args)``, counted as it runs."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops() / 1e9


def _ms_per_call(fn: Callable[[], Any], n: int, device: torch.device) -> float:
    """Mean ms of ``n`` calls: CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def profile_model(model: torch.nn.Module, input_shape: tuple[int, ...] = (1, 224, 224, 3),
                  n: int = 10, dtype: torch.dtype = torch.float32) -> dict:
    """Params (M), forward GFLOPs, forward ms and forward+backward ms (the
    gradient of the output's sum for every parameter) on a zero input of
    ``input_shape`` in ``dtype`` on the model's device, after one warm-up
    call of each; memory as ``device_memory_mb`` with the peak of these
    calls (the training-shaped footprint)."""
    device = next(model.parameters()).device
    x = torch.zeros(input_shape, dtype=dtype, device=device)

    def fwd():
        with torch.no_grad():
            return model(x)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        model(x).float().sum().backward()

    with frozen(model):
        gflops = flops(fwd)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fwd()
    fwd_bwd()
    out = {
        "params_m": count_params(model),
        "gflops": gflops,
        "fwd_ms": _ms_per_call(fwd, n, device),
        "fwd_bwd_ms": _ms_per_call(fwd_bwd, n, device),
        **device_memory_mb(device),
    }
    model.zero_grad(set_to_none=True)
    return out
