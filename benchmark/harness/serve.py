"""A serve cell: the backbone exported and loaded (``export_model``,
``load_exported``) and served in its compute type to one client in a closed
loop, from a pool of seeded device inputs: the protocol of timm's
``benchmark.py`` inference run (a fixed batch, each step timed to a
synchronize), with the traffic's batch sizes.

The requests' batch sizes come in rounds, each round every size of the
traffic once in a seeded order, so every seed serves the same mix. Each
request is timed from its call to the synchronize that returns its
features. A seeded sample of the requests keeps its features; once the
window has closed and the program is freed, the plain reference computes the
same inputs' features in f32 (TF32 off), and the worst image's cosine
distance and relative L2 gap are compared (``compare.serve_numbers``).
"""

from __future__ import annotations

import itertools
import time
from typing import Iterator

import numpy as np
import torch

from ..reference import models as ref_models
from . import compare, trace, weights


def schedule(seed: int, sizes: list[int], pool: int) -> Iterator[tuple[int, int]]:
    """The requests, without end: (batch size, pool index), rounds of every
    size once, shuffled by the seed."""
    rng = np.random.default_rng(weights.sub_seed(seed, weights.REQUESTS))
    while True:
        for k in rng.permutation(len(sizes)):
            yield sizes[k], int(rng.integers(pool))


def program(arch: dict, kwargs: dict, seed: int, device: torch.device, dtype: torch.dtype,
            max_batch: int,
            int8: bool = False):
    """The served callable: the configured backbone with the benchmark's
    weights, exported at ``max_batch`` (the batch stays free) and loaded."""
    from vision_toolbox_tpu_torch import create_backbone
    from vision_toolbox_tpu_torch.utils.export import export_model, load_exported

    model = create_backbone(arch["backbone"], dtype=dtype, device=device, **kwargs)
    ref_meta = ref_models.build(arch, classifier=False, device="meta")
    weights.load(model, weights.make(ref_meta, seed, device))
    model.eval()
    if int8:
        from vision_toolbox_tpu_torch.utils.int8_serving import quantize_model

        model = quantize_model(model)
    shape = (max_batch, arch["image_size"], arch["image_size"], 3)
    return load_exported(export_model(model, shape, dtype=dtype))


def inputs(seed: int, sizes: list[int], pool: int, size: int, device: torch.device,
           dtype: torch.dtype) -> dict[int, list[torch.Tensor]]:
    """``pool`` seeded input batches of each size, in [0, 1], on the device."""
    imgs = weights.images(seed, weights.SAMPLE, pool * sum(sizes), size, device)
    out, at = {}, 0
    for s in sizes:
        out[s] = []
        for _ in range(pool):
            out[s].append((imgs[at:at + s].to(dtype) / 255.0).contiguous())
            at += s
    return out


def run(cell, seed: int, seconds: float, do_trace: bool, dev, t_start: float,
        fault: str | None = None) -> dict:
    device, sync = dev.device, dev.sync
    arch, traffic = cell.config["architecture"], cell.traffic
    dtype = getattr(torch, cell.config["compute_dtype"])
    sizes, pool = traffic["batch_sizes"], traffic["pool_per_size"]
    kwargs = cell.config["recipe"]["model"].get("backbone_kwargs", {})
    served = program(arch, kwargs, seed, device, dtype, max(sizes), int8=fault == "int8")
    if fault in ("altered_answer", "scaled_answer"):
        inner = served

        def served(x):
            y = inner(x)
            if fault == "scaled_answer":  # the right direction, 10% long
                return y * 1.1
            return torch.cat([y[:1] + 1.0, y[1:]])

    pool_x = inputs(seed, sizes, pool, arch["image_size"], device, dtype)
    with torch.no_grad():
        for s in sizes:
            for i in range(traffic["warmup_per_size"]):
                served(pool_x[s][i % pool])
    sync()
    setup_peak = dev.peak()
    dev.reset_peak()
    setup_s = time.perf_counter() - t_start

    plan = schedule(seed, sizes, pool)
    every = traffic["sample_every"]
    offset = int(np.random.default_rng(weights.sub_seed(seed, weights.SAMPLE)).integers(every))
    lat, enq, kept, longest = [], [], [], False
    n_img, t0 = 0, time.perf_counter()
    with torch.no_grad():
        for r, (s, k) in enumerate(plan):
            if time.perf_counter() - t0 >= seconds:
                break
            t_call = time.perf_counter()
            y = served(pool_x[s][k])
            enq.append(time.perf_counter() - t_call)
            sync()
            lat.append(time.perf_counter() - t_call)
            n_img += s
            if r % every == offset or (s == max(sizes) and not longest):
                kept.append((s, k, y))
                longest = longest or s == max(sizes)
    window_s = time.perf_counter() - t0
    window_peak = dev.peak()
    out = {"arch": arch, "setup_s": setup_s, "window_s": window_s, "requests": len(lat),
           "images": n_img, "latencies": lat, "enqueue": enq, "peak_bytes": window_peak}

    if do_trace:
        rounds = list(itertools.islice(schedule(seed + 1, sizes, pool),
                                       traffic["profiled_rounds"] * len(sizes)))
        it = iter(rounds)

        def one_request():
            s, k = next(it)
            with torch.no_grad():
                served(pool_x[s][k])
            sync()

        out["trace"] = trace.profile(one_request, len(rounds), sync)
        out["trace_sizes"] = [s for s, _ in rounds]
    out["memory_peak_bytes"] = max(setup_peak, window_peak, dev.peak())

    del served
    dev.free()
    out["numbers"] = compare.serve_numbers(gaps(arch, seed, kept, pool_x, device))
    from .flops import forward_flops

    out["flops_per_image"] = forward_flops(ref_models.build(arch, classifier=False,
                                                            device="meta"),
                                           (1, arch["image_size"], arch["image_size"], 3))
    return out


def gaps(arch: dict, seed: int, kept: list, pool_x: dict, device: torch.device,
         fp8: bool = False) -> list[float]:
    """Each kept image's relative gap of its features to the plain
    reference's on the same inputs (each pool input computed once)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = ref_models.build(arch, classifier=False, device=device, fp8=fp8)
        weights.load(model, weights.make(model, seed, device))
        refs, out = {}, []
        with torch.no_grad():
            for s, k, y in kept:
                if (s, k) not in refs:
                    x = pool_x[s][k].float()
                    refs[(s, k)] = torch.cat([model(x[i:i + 32]) for i in range(0, s, 32)])
                out += compare.feature_gaps(y.float(), refs[(s, k)])
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

