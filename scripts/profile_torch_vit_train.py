"""Where the time of the port's train step goes, on one NVIDIA card.

    python3 scripts/profile_torch_vit_train.py [vit_b_16 | cait_s_24 | vit_b_16_siglip512 | convnext_t
                                                | swin_t | vit_b_16_unfused | mixer_b_16
                                                | patchconvnet_s | vovnet57
                                                | efficientnet_b0 | resnet50]

Builds the step of one of ``chip_smoke.py``'s training phases (vit_b_16 by
default, or cait_s_24, bs128@224; or vit_b_16 SigLIP at 512 px with its MAP
head and no cls token, bs64@512; or convnext_t with stochastic depth 0.1,
or swin_t with stochastic depth 0.2, bs128@224; or vit_b_16 on the unfused
block chain, mixer_b_16, or patchconvnet_s with drop-path 0.3, or
efficientnet_b0 with drop-path 0.2, bs128@224; or resnet50, bs256@224;
bf16 compute, f32 parameters, CutMix⊕MixUp, label smoothing 0.1, SGD
momentum 0.9 with weight decay 2e-5 in three groups; or vovnet57 on the
full recipe of configs/base.yaml at its bs512@176, as cell (b) runs
cspdarknet53: TrivialAugment through K1, RandomErasing 0.1, warmup-cosine)
and its warm-up and timed step counts, times it unprofiled with CUDA events
and the host clock, then traces ``PROFILED_STEPS`` more steps with
``torch.profiler`` and sums the device kernels by class:

- flash-attention kernels (SigLIP at 512 px): the K6 forward, and the K6
  backward's dK/dV, dQ and delta kernels, each a class of its own;
- short-attention kernels (vit_b_16 on the unfused chain): the K2 forward,
  and the K2 backward's row (dq) and key (dK/dV) kernels;
- talking-head kernels (CaiT): the K5 forward, and the K5 backward's row
  pass, key pass and mix-gradient sum;
- depthwise-conv kernels (ConvNeXt): the K9 forward with the backward's dx
  pass (one kernel, the flipped weights for dx), and the backward's dw block
  partials and their fixed-order sum;
- window-attention kernels (Swin): the K7 forward, and the K7 backward with
  its fixed-order dPE sum; the shifted-window relayout kernels (K8, both
  directions);
- forward kernels: the K3/K4 forward (the LayerNorm row pass, the GEMM
  template with the weight read (N, K), the attention kernel);
- backward kernels: the K3/K4 backward (the GEMM template with the weight
  read (K, N), the attention backward kernels, the cotangent and LayerNorm
  row kernels, the fixed-order column sums);
- library products: cuBLAS/CUTLASS GEMMs, i.e. the weight gradients of the
  blocks (``torch.matmul``), CaiT's q/k/v/out projections (``F.linear``
  around K5) and class attention, the unfused chain's projections and MLPs,
  and the head's three small products;
- the three-shear warp (K1, TrivialAugment's geometric ops) and max
  pooling (VoVNet's stages);
- convolutions (cuDNN: the patch embedding; ConvNeXt's stem and
  downsampling; PatchConvNet's stem and SE; VoVNet's), optimizer (SGD's
  foreach kernels), and the rest (casts of
  the f32 parameters to bf16, the loss, the unfused LayerNorms (ConvNeXt's
  stem, downsampling and final ones, Swin's attention-half and patch-merging
  ones) and GRN, the relative-position gathers, the unshifted blocks'
  window reshapes, the BatchNorms' statistics and affine (VoVNet,
  PatchConvNet), GELUs, CutMix⊕MixUp, copies).

The input pipeline alone is traced the same way over the same number of
steps. The idle share is 1 − kernel time / step time, against the unprofiled
step (CUDA events) and against the profiled window (kernels run one at a
time on one stream); the profiler's own host time stretches the window of a
step of many short kernels (swin_t), so the first is the card's. Prints the table and one JSON line, and writes
``chiprun_out/profile_<model>_train.json``. Needs a CUDA card.
"""

from __future__ import annotations

import collections
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
PROFILED_STEPS = 3

# gemm_kernel<Epilogue, TX, BLayout, SAVE, BN>: BLayout 0 reads the weight
# (N, K) (the forward products), 1 reads it (K, N) (the backward products)
_GEMM = re.compile(r"gemm_kernel<\d+, [^,]+, (\d+),")


def _gemm_layout(name: str) -> str | None:
    m = _GEMM.search(name)
    return m.group(1) if m else None


CLASSES = (
    ("flash-attention forward (K6 fwd)", lambda n: "flash_fwd_kernel" in n),
    ("flash-attention backward dK/dV (K6 bwd)", lambda n: "flash_bwd_dkv_kernel" in n),
    ("flash-attention backward dQ (K6 bwd)", lambda n: "flash_bwd_dq_kernel" in n),
    ("flash-attention backward delta (K6 bwd)", lambda n: "flash_delta_kernel" in n),
    ("short-attention forward (K2 fwd)", lambda n: "short_fwd_kernel" in n),
    ("short-attention backward (K2 bwd)", lambda n: "short_bwd_" in n),
    ("talking-head forward (K5 fwd)", lambda n: "th_fwd_kernel" in n),
    ("talking-head backward (K5 bwd)", lambda n: any(
        k in n for k in ("th_bwd_rows_kernel", "th_bwd_keys_kernel", "th_param_reduce_kernel"))),
    ("depthwise conv, forward and backward dx (K9 dw_conv_kernel)",
     lambda n: "dw_conv_kernel" in n),
    ("depthwise conv backward dw (K9 wgrad + reduce)",
     lambda n: "dw_wgrad_kernel" in n or "dw_reduce_kernel" in n),
    ("window attention forward (K7 fwd)", lambda n: "swin_fwd" in n),
    ("window attention backward (K7 bwd + dPE sum)",
     lambda n: "swin_bwd" in n or "dpe_reduce_kernel" in n),
    ("shifted-window relayout (K8, both directions)", lambda n: "partition_kernel" in n),
    ("forward kernels (K3/K4 fwd)",
     lambda n: _gemm_layout(n) == "0" or "attn_kernel" in n or "ln_rows_kernel" in n),
    ("backward kernels (K3/K4 bwd)", lambda n: _gemm_layout(n) == "1" or any(
        k in n for k in ("attn_bwd", "douts_kernel", "ln_bwd_kernel", "colsum_kernel"))),
    ("three-shear warp (K1)", lambda n: "warp_shear3_kernel" in n),
    ("max pooling (PyTorch)", lambda n: "max_pool" in n.lower()),
    ("convolutions (cuDNN)", lambda n: any(
        k in n.lower() for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad"))),
    ("library products (weight gradients, head)", lambda n: any(
        k in n.lower() for k in ("cutlass", "xmma", "nvjet", "gemm", "cublas"))),
    ("optimizer (SGD foreach)", lambda n: "multi_tensor" in n or "foreach" in n.lower()),
)


def classify(name: str) -> str:
    for label, match in CLASSES:
        if match(name):
            return label
    return "rest (casts, loss, unfused norms, BatchNorms, GRN, CutMix⊕MixUp, copies)"


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
    tag = sys.argv[1] if len(sys.argv) > 1 else "vit_b_16"
    # name → (phase config, the builder of its step's parts)
    cs = chip_smoke

    def vit(name, cfg, forward_kw=None, **model_kw):
        return cfg, functools.partial(cs.vit_step_parts, name, cfg, forward_kw, **model_kw)

    configs = {"vit_b_16": vit("vit_b_16", cs.VIT_TRAIN),
               "cait_s_24": vit("cait_s_24", cs.CAIT_TRAIN),
               "vit_b_16_siglip512": vit("vit_b_16", cs.SIGLIP_TRAIN, **cs.SIGLIP),
               "convnext_t": vit("convnext_t", cs.CONVNEXT_TRAIN, **cs.CONVNEXT_KW),
               "swin_t": vit("swin_t", cs.SWIN_TRAIN, **cs.SWIN_KW),
               "vit_b_16_unfused": vit("vit_b_16", cs.VIT_UNFUSED_TRAIN, cs.UNFUSED),
               "mixer_b_16": vit("mixer_b_16", cs.MIXER_TRAIN),
               "patchconvnet_s": vit("patchconvnet_s", cs.PATCHCONV_TRAIN),
               "efficientnet_b0": vit("efficientnet_b0", cs.EFFICIENTNET_TRAIN,
                                      **cs.EFFICIENTNET_KW),
               "resnet50": vit("resnet50", cs.RESNET_TRAIN),
               # the full recipe, cell (b)'s step
               "vovnet57": (cs.VOVNET_TRAIN,
                            functools.partial(cs.recipe_step_parts, cs.VOVNET_TRAIN))}
    if tag not in configs:
        print(f"profile_torch_vit_train: model must be one of {sorted(configs)}", file=sys.stderr)
        return 2
    cfg, step_parts = configs[tag]
    state, step, images, labels, g = step_parts()
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
        card=card, model=tag, batch=cfg["batch"], img=cfg["img"],
        ms_per_step_events=ms_events, ms_per_step_host=ms_host,
        img_per_s=cfg["batch"] / ms_events * 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        profiled_window_ms=window, kernel_ms=total, idle_share=1 - total / ms_events,
        idle_share_of_window=1 - total / window,
        classes_ms=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        input_pipeline_ms=pipeline,
        top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:25]),
    )
    print(f"{tag} bs{cfg['batch']}@{cfg['img']} train step [{card}]: {ms_events:.2f} ms/step "
          f"(events, {n} steps; host {ms_host:.2f}), {result['img_per_s']:.1f} img/s")
    print(f"profiled: window {window:.2f} ms/step, kernels {total:.2f} ms/step, idle share "
          f"{result['idle_share']:.3f} of the step ({result['idle_share_of_window']:.3f} of the "
          "window)")
    for label, ms in result["classes_ms"].items():
        print(f"  {label:55s} {ms:9.3f} ms  {ms / total:6.1%}")
    print(f"  {'input pipeline alone (augmentations, one-hot, casts)':55s} {pipeline:9.3f} ms")
    for name, ms in list(result["top_kernels_ms"].items())[:12]:
        print(f"    {ms:8.3f} ms  {name[:110]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{tag}_train.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "top_kernels_ms"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
