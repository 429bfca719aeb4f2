"""Where the time of the port's vit_b_16 train step goes, on one NVIDIA card.

    python3 scripts/profile_torch_vit_train.py

Builds the step of ``chip_smoke.py``'s transformer-training phase (vit_b_16,
bs128@224, bf16 compute, f32 parameters, CutMix⊕MixUp, label smoothing 0.1,
SGD momentum 0.9 with weight decay 2e-5 in three groups) and its warm-up
and timed step counts, times it unprofiled with CUDA events and the host
clock, then traces ``PROFILED_STEPS`` more steps with ``torch.profiler`` and
sums the device kernels by class:

- forward kernels: the K3/K4 forward (the GEMM template with the weight
  read (N, K), the attention kernel);
- backward kernels: the K3/K4 backward (the GEMM template with the weight
  read (K, N), the attention backward kernels, the cotangent and LayerNorm
  row kernels);
- library products: cuBLAS/CUTLASS GEMMs, i.e. the weight gradients of the
  blocks (``torch.matmul``) and the head's three small products;
- patch-embedding convolution (cuDNN), optimizer (SGD's foreach kernels),
  and the rest (casts of the f32 parameters to bf16, the loss, the final
  LayerNorm, CutMix⊕MixUp, copies).

The input pipeline alone is traced the same way over the same number of
steps. The idle share is 1 − kernel time / profiled window (kernels run one
at a time on one stream). Prints the table and one JSON line, and writes
``chiprun_out/profile_vit_train.json``. Needs a CUDA card.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
PROFILED_STEPS = 3

# gemm_kernel<AMode, Epilogue, TX, BLayout, SAVE>: BLayout 0 reads the weight
# (N, K) (the forward products), 1 reads it (K, N) (the backward products)
_GEMM = re.compile(r"gemm_kernel<\d+, \d+, [^,]+, (\d+)")


def _gemm_layout(name: str) -> str | None:
    m = _GEMM.search(name)
    return m.group(1) if m else None


CLASSES = (
    ("forward kernels (K3/K4 fwd)",
     lambda n: _gemm_layout(n) == "0" or "attn_kernel" in n),
    ("backward kernels (K3/K4 bwd)", lambda n: _gemm_layout(n) == "1"
     or any(k in n for k in ("attn_bwd", "douts_kernel", "ln_bwd_kernel"))),
    ("library products (weight gradients, head)", lambda n: any(
        k in n.lower() for k in ("cutlass", "xmma", "nvjet", "gemm", "cublas"))
     and "conv" not in n.lower()),
    ("patch-embedding convolution (cuDNN)", lambda n: "conv" in n.lower() or "cudnn" in n.lower()),
    ("optimizer (SGD foreach)", lambda n: "multi_tensor" in n or "foreach" in n.lower()),
)


def classify(name: str) -> str:
    for label, match in CLASSES:
        if match(name):
            return label
    return "rest (casts, loss, final norm, CutMix⊕MixUp, copies)"


def device_kernels(prof) -> list[tuple[str, float]]:
    """(name, µs) of every kernel the trace saw on the card."""
    out = []
    for e in prof.events():
        annotation = getattr(e, "is_user_annotation", False)
        if e.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            out.append((e.name, e.time_range.elapsed_us()))
    return out


def traced(fn, steps: int):
    """Trace ``fn`` ``steps`` times: (kernels, host window in ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    return device_kernels(prof), window


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_vit_train: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = chip_smoke.VIT_TRAIN
    state, step, images, labels, g = chip_smoke.vit_step_parts("vit_b_16", cfg)
    for _ in range(cfg["warmup"]):
        step(state, images, labels, g)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    n = cfg["steps"]
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        step(state, images, labels, g)
    end.record()
    end.synchronize()
    ms_events = start.elapsed_time(end) / n
    ms_host = (time.perf_counter() - t0) * 1e3 / n

    kernels, window = traced(lambda: step(state, images, labels, g), PROFILED_STEPS)
    by_class = collections.defaultdict(float)
    by_name = collections.defaultdict(float)
    for name, us in kernels:
        by_class[classify(name)] += us / 1e3 / PROFILED_STEPS
        by_name[name] += us / 1e3 / PROFILED_STEPS
    total = sum(by_class.values())
    draws = [step.sample_draws(g, tuple(images.shape)) for _ in range(PROFILED_STEPS)]
    it = iter(draws)
    pipe_kernels, _ = traced(lambda: step.augment(images, labels, next(it)), PROFILED_STEPS)
    pipeline = sum(us for _, us in pipe_kernels) / 1e3 / PROFILED_STEPS

    window /= PROFILED_STEPS
    result = dict(
        card=card, model="vit_b_16", batch=cfg["batch"], img=cfg["img"],
        ms_per_step_events=ms_events, ms_per_step_host=ms_host,
        img_per_s=cfg["batch"] / ms_events * 1e3,
        profiled_window_ms=window, kernel_ms=total, idle_share=1 - total / window,
        classes_ms=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        input_pipeline_ms=pipeline,
        top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:25]),
    )
    print(f"vit_b_16 bs{cfg['batch']}@{cfg['img']} train step [{card}]: {ms_events:.2f} ms/step "
          f"(events, {n} steps; host {ms_host:.2f}), {result['img_per_s']:.1f} img/s")
    print(f"profiled: window {window:.2f} ms/step, kernels {total:.2f} ms/step, idle share "
          f"{result['idle_share']:.3f}")
    for label, ms in result["classes_ms"].items():
        print(f"  {label:55s} {ms:9.3f} ms  {ms / total:6.1%}")
    print(f"  {'input pipeline alone (CutMix⊕MixUp, one-hot, casts)':55s} {pipeline:9.3f} ms")
    for name, ms in list(result["top_kernels_ms"].items())[:12]:
        print(f"    {ms:8.3f} ms  {name[:110]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_vit_train.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "top_kernels_ms"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
