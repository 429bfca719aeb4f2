"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vision_toolbox_tpu_torch/csrc`` (nvcc,
sm_90a) and drives both of the port's paths:

- serving (slice 1): holds the fused attention/MLP kernels against their
  plain PyTorch versions at the vit_b_16 shapes the model gives them, runs a
  seeded bf16 vit_b_16 (224 px, random weights) eagerly and through its plain
  versions, then serves it: export → load → requests at batch 1, 8 and 32,
  each checked against eager;
- training (slice 2): holds the three-shear warp kernel (K1) against its
  plain version at bs256@176 and at 32 px, then runs the full-recipe
  cspdarknet53 train step (bs256, 176 px, TrivialAugment, RandomErasing 0.1,
  CutMix⊕MixUp, bf16 compute, f32 params, SGD) for 3 warm-up and 10 timed
  steps, and one step through K1 against one through its plain version;
- transformer training (slice 3): holds the backward-save forward and the
  backward kernels of the MLP and attention half-blocks against their plain
  versions at the vit_b_16 shapes (and T = 512 for attention), times each
  backward against its plain version, runs the vit_b_16 train step (bs128,
  224 px, CutMix⊕MixUp, label smoothing 0.1, bf16 compute, f32 params, SGD)
  for 3 warm-up and 10 timed steps, one step through the kernels against
  one through the plain versions, and a few deit3_b_16 steps with
  stochastic depth 0.1 (the LayerScale and drop-path branches).

Every phase prints what it found; any failure raises and exits non-zero.
Needs a CUDA card: without one it exits 1 and prints no result.

The last three lines are: the kernels as JSON (route, source, the TPU kernel
each replaces, launches in its path's run, error against the plain version,
time of kernel and plain version, the least time the card could take for
the same work and whether bytes or operations set it, and the time of one
PyTorch call computing the same function where there is one), the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json`` beside this file.
"""

from __future__ import annotations

import copy
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "block_mlp": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/block_mlp.cu",
        "replaces": "vision_toolbox_tpu/ops/block_mlp.py:365",
    },
    "block_attention": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/block_attention.cu",
        "replaces": "vision_toolbox_tpu/ops/block_attention.py:317",
    },
    "block_mlp_bwd": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/block_mlp_bwd.cu",
        "replaces": "vision_toolbox_tpu/ops/block_mlp.py:420",
    },
    "block_attention_bwd": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/block_attention_bwd.cu",
        "replaces": "vision_toolbox_tpu/ops/block_attention.py:358",
    },
    "warp_shear3": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/warp_shear3.cu",
        "replaces": "vision_toolbox_tpu/ops/warp_pallas.py:166",
    },
}
SERVE_KERNELS = ("block_mlp", "block_attention")
BLOCK_KERNELS = ("block_mlp", "block_attention", "block_mlp_bwd", "block_attention_bwd")
BOUND = {torch.float32: 1e-3, torch.bfloat16: 2e-2}  # × max|plain|
VIT_B = dict(D=768, H=12, Dh=3072)
SERVE_BATCHES = (1, 8, 32)
REL_L2_BOUND = 1e-2
WARP_BOUND = 1e-5  # max abs, [0, 1] images: same f32 operations on both sides
TRAIN = dict(batch=256, img=176, classes=1000, warmup=3, steps=10)
LOSS_REL_BOUND = 1e-3  # kernel-path vs plain-path step: bf16 rounding flips only
BWD_REL_L2 = 1e-2  # reduced and weight gradients of a backward kernel vs its plain version
GRAD_REL_L2 = 2e-2  # every parameter gradient, kernel-path step vs plain-path step
VIT_TRAIN = dict(batch=128, img=224, classes=1000, warmup=3, steps=10, lr=0.1)
DEIT3 = dict(batch=16, img=224, classes=1000, steps=3, stochastic_depth=0.1)
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 tensor
# cores and device memory; the least time of a kernel is the larger of its
# operations and its bytes over these.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def alternate(plain, kernel, **kw) -> tuple[float, float]:
    """Times in turns (plain, kernel, kernel, plain); mean of each pair."""
    p1, k1, k2, p2 = time_ms(plain, **kw), time_ms(kernel, **kw), time_ms(kernel, **kw), \
        time_ms(plain, **kw)
    return (p1 + p2) / 2, (k1 + k2) / 2


def rel_l2(a: torch.Tensor, b: torch.Tensor, ref: torch.Tensor | None = None) -> float:
    """‖a − b‖ / ‖ref‖ (ref defaults to b)."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / (b if ref is None else ref.float()).norm()).item()


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms on the card, what sets it): operations over the bf16 peak
    against bytes (each input read once, each output written once) over the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def block_work(name: str, B: int, T: int, x_bytes: int, ls: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one call of a half-block kernel at vit_b_16
    widths: the products the kernel runs and the tensors it must read and
    write (x/dout/dx in ``x_bytes`` per element, saves and weights bf16)."""
    D, Dh, H = VIT_B["D"], VIT_B["Dh"], VIT_B["H"]
    M, vec = B * T, 4 * D
    if name == "block_mlp":  # x, out; W1, W2; biases, LN
        return 4 * M * D * Dh, 2 * M * D * x_bytes + 4 * D * Dh + 4 * vec + 4 * Dh
    if name == "block_attention":  # x, out; Wq/k/v/o; q·kᵀ and p·v per image
        return 8 * M * D * D + 4 * B * T * T * D, 2 * M * D * x_bytes + 8 * D * D + 6 * vec
    if name == "block_mlp_bwd":  # dout, xhat, rstd, h (, mlpout); W1, W2 → dx, dh, 5 sums
        flops = 4 * M * D * Dh
        nbytes = (2 * M * D * x_bytes + 2 * M * D + 4 * M + 4 * M * Dh + 4 * D * Dh
                  + 2 * M * D * ls + 6 * vec + 4 * Dh)
        return flops, nbytes
    # block_attention_bwd: dout, xhat, rstd, q, k, v, p (, proj); Wo, Wq/k/v
    #   → dx, dq, dk, dv, 7 sums; do = douts·Wo, dy over 3·D, 4 attention products
    flops = 2 * M * D * D + 6 * M * D * D + 8 * B * T * T * D
    nbytes = (2 * M * D * x_bytes + 2 * M * D + 4 * M + 12 * M * D + 2 * B * H * T * T
              + 2 * M * D * ls + 8 * D * D + 8 * vec)
    return flops, nbytes


def mlp_args(g, B, T, D, Dh, dtype, extras, residual):
    r = lambda *s, scale=1.0, shift=0.0: (torch.randn(s, generator=g) * scale + shift)
    a = dict(
        x=r(B, T, D), ln_scale=r(D, scale=0.1, shift=1.0), ln_bias=r(D, scale=0.1),
        w1=r(Dh, D, scale=D**-0.5), b1=r(Dh, scale=0.1),
        w2=r(D, Dh, scale=Dh**-0.5), b2=r(D, scale=0.1),
        ls_gamma=r(D, scale=0.2, shift=0.5) if extras else None,
        residual=r(B, T, D) if residual else None,
    )
    a = {k: None if v is None else v.to("cuda", dtype) for k, v in a.items()}
    a["dp_scale"] = ((torch.rand(B, 1, generator=g) < 0.8).float() / 0.8).cuda() if extras else None
    return a


def attn_args(g, B, T, D, H, dtype, extras):
    r = lambda *s, scale=1.0, shift=0.0: (torch.randn(s, generator=g) * scale + shift)
    a = dict(x=r(B, T, D), ln_scale=r(D, scale=0.1, shift=1.0), ln_bias=r(D, scale=0.1))
    for n in ("q", "k", "v", "o"):
        a[f"w{n}"], a[f"b{n}"] = r(D, D, scale=D**-0.5), r(D, scale=0.1)
    a["ls_gamma"] = r(D, scale=0.2, shift=0.5) if extras else None
    a = {k: None if v is None else v.to("cuda", dtype) for k, v in a.items()}
    a["n_heads"] = H
    a["dp_scale"] = ((torch.rand(B, 1, generator=g) < 0.8).float() / 0.8).cuda() if extras else None
    return a


def compare_kernels(report: dict) -> dict[str, float]:
    """Phase 3: each kernel vs its plain version; returns the max abs error
    at the main path's case (vit_b_16, batch 8, bf16, no γ/dp)."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(0)
    main_err = {}
    rows = []
    for B, T in ((8, 197), (3, 50)):
        for dtype in (torch.float32, torch.bfloat16):
            for variant in ("plain", "ls+dp", "ls+dp+residual"):
                a = mlp_args(g, B, T, VIT_B["D"], VIT_B["Dh"], dtype, variant != "plain",
                             variant.endswith("residual"))
                cases = [("block_mlp", bm.fused_mlp_block_plain(**a), bm.fused_mlp_block(**a))]
                if variant != "ls+dp+residual":
                    a = attn_args(g, B, T, VIT_B["D"], VIT_B["H"], dtype, variant != "plain")
                    cases.append(("block_attention", ba.fused_attention_block_plain(**a),
                                  ba.fused_attention_block(**a)))
                torch.cuda.synchronize()
                for name, want, got in cases:
                    err = (got.float() - want.float()).abs().max().item()
                    scale = want.float().abs().max().item()
                    ok = bool(torch.isfinite(got.float()).all()) and err <= BOUND[dtype] * scale
                    row = dict(kernel=name, B=B, T=T, dtype=str(dtype).split(".")[-1],
                               variant=variant, max_abs_err=err, max_abs_plain=scale,
                               bound=BOUND[dtype] * scale, ok=ok)
                    rows.append(row)
                    log(f"[compare] {name:15s} B={B} T={T} {row['dtype']:8s} {variant:15s} "
                        f"max|err|={err:.3e} bound={row['bound']:.3e} "
                        f"({err / scale:.2e}·max|plain|) {'ok' if ok else 'FAIL'}")
                    if (B, dtype, variant) == (8, torch.bfloat16, "plain"):
                        main_err[name] = err
    report["compare"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel comparisons out of bounds: {bad}")
    return main_err


def time_kernels(report: dict) -> dict[str, tuple[float, float]]:
    """Kernel vs plain time at vit_b_16 shapes, bf16, batch 8 and 128."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(1)
    out, rows = {}, []
    for B in (8, 128):
        m = mlp_args(g, B, 197, VIT_B["D"], VIT_B["Dh"], torch.bfloat16, False, False)
        a = attn_args(g, B, 197, VIT_B["D"], VIT_B["H"], torch.bfloat16, False)
        for name, plain, kernel in (
            ("block_mlp", lambda: bm.fused_mlp_block_plain(**m), lambda: bm.fused_mlp_block(**m)),
            ("block_attention", lambda: ba.fused_attention_block_plain(**a),
             lambda: ba.fused_attention_block(**a)),
        ):
            plain_ms, ms = alternate(plain, kernel, iters=10 if B == 128 else 20)
            rows.append(dict(kernel=name, B=B, T=197, dtype="bfloat16", ms=ms, plain_ms=plain_ms))
            log(f"[time] {name:15s} B={B:3d} T=197 bf16 kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
            if B == 8:
                out[name] = (ms, plain_ms)
    report["kernel_times"] = rows
    return out


def warp_case(g, B, S):
    """[0, 1] images and a program mix: identity, ±shear X/Y, ±translate,
    rotations at k90 = −1, 0, +1 and near ±45° and ±135°, then random ops."""
    from vision_toolbox_tpu_torch.ops import trivial_augment as ta

    fixed = [(ta.OP_IDENTITY, 0.0), (ta.OP_SHEAR_X, 0.9), (ta.OP_SHEAR_X, -0.5),
             (ta.OP_SHEAR_Y, 0.7), (ta.OP_SHEAR_Y, -1.0), (ta.OP_TRANSLATE_X, 0.6),
             (ta.OP_TRANSLATE_Y, -0.8), (ta.OP_ROTATE, 1.0), (ta.OP_ROTATE, -1.0),
             (ta.OP_ROTATE, 1 / 3), (ta.OP_ROTATE, -1 / 3 - 1e-3), (ta.OP_ROTATE, 0.2),
             (ta.OP_ROTATE, 0.98), (ta.OP_EQUALIZE, 0.5)]
    op = torch.randint(0, ta.NUM_OPS, (B,), generator=g)
    mag = torch.rand(B, generator=g) * 2 - 1
    n = min(B, len(fixed))
    op[:n] = torch.tensor([o for o, _ in fixed[:n]])
    mag[:n] = torch.tensor([m for _, m in fixed[:n]])
    return torch.rand(B, S, S, 3, generator=g).cuda(), op.cuda(), mag.cuda()


def compare_warp(report: dict) -> tuple[float, float, float]:
    """Phase 6: K1 vs its plain version (same program) at bs256@176 and
    B=5 at 32 px; time both at bs256@176. Returns (err, ms, plain_ms)."""
    from vision_toolbox_tpu_torch.ops import warp

    g = torch.Generator().manual_seed(6)
    rows, main = [], None
    for B, S in ((256, 176), (5, 32)):
        x, op, mag = warp_case(g, B, S)
        program = warp.shear3_params(op, mag)
        want = warp.shear3_warp_plain(x, program)
        got = warp.shear3_warp_cuda(x, program)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and got.shape == x.shape and err <= WARP_BOUND
        rows.append(dict(B=B, S=S, max_abs_err=err, bound=WARP_BOUND, ok=ok,
                         k90=sorted(set(program[0].tolist()))))
        log(f"[warp] K1 vs plain B={B} {S}px: max|err|={err:.3e} (bound {WARP_BOUND}) "
            f"k90 {rows[-1]['k90']} {'ok' if ok else 'FAIL'}")
        if B == 256:
            plain_ms, ms = alternate(lambda: warp.shear3_warp_plain(x, program),
                                     lambda: warp.shear3_warp_cuda(x, program), iters=10)
            main = (err, ms, plain_ms)
            log(f"[warp] bs256@176 f32: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
    report["warp"] = dict(compare=rows, ms=main[1], plain_ms=main[2])
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"K1 disagrees with its plain version: {rows}")
    return main


@contextlib.contextmanager
def plain_warp():
    """Route the three-shear warp through its plain version on the card."""
    from vision_toolbox_tpu_torch.ops import warp

    kernel = warp.shear3_warp_cuda
    warp.shear3_warp_cuda = warp.shear3_warp_plain
    try:
        yield
    finally:
        warp.shear3_warp_cuda = kernel


@contextlib.contextmanager
def plain_attention():
    """Let the unfused attention run its plain f32 math on the card at the
    shapes the JAX package gives its short-attention kernel (K2, not ported:
    ``ops/attention.py`` raises there), for an f32 reference."""
    from vision_toolbox_tpu_torch.ops import attention

    unported = attention._unported_kernel
    attention._unported_kernel = lambda *args: None
    try:
        yield
    finally:
        attention._unported_kernel = unported


def train(report: dict, name_power: str) -> int:
    """Phase 7 (the training path): the full-recipe cspdarknet53 step at
    bs256@176, 3 warm-up + 10 timed steps; then phase 8, one step through K1
    against one through its plain version from one state and one set of
    draws. Returns K1's launches in the training run."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.train import (
        ImageClassifier, TrainState, make_train_step, sgd_with_param_groups,
        warmup_cosine_schedule,
    )

    B, S, classes = TRAIN["batch"], TRAIN["img"], TRAIN["classes"]
    gen = torch.Generator().manual_seed(0)
    backbone = vtt.create_backbone("cspdarknet53", dtype=torch.bfloat16, device="cuda",
                                   generator=gen)
    model = ImageClassifier(backbone, classes, dtype=torch.bfloat16, generator=gen)
    schedule = warmup_cosine_schedule(0.5 * B / 1024, 100, 1_281_167 // B)
    opt = sgd_with_param_groups(model, schedule, momentum=0.9, weight_decay=2e-5)
    state = TrainState(model, opt)
    step = make_train_step(classes, label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0,
                           trivial_augment=True, random_erasing_p=0.1,
                           compute_dtype=torch.bfloat16)
    data = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randint(0, 256, (B, S, S, 3), dtype=torch.uint8, device="cuda", generator=data)
    labels = torch.randint(0, classes, (B,), device="cuda", generator=data)
    g = torch.Generator(device="cuda").manual_seed(2)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] cspdarknet53 + head {classes}: {n_params / 1e6:.2f} M f32 params, bf16 compute, "
        f"bs{B}@{S}, TA + RE 0.1 + CutMix⊕MixUp, SGD 0.9, wd 2e-5 (3 groups), cudnn TF32 off")
    watched = ("head.weight", "backbone.stem.conv.weight", "backbone.stem.norm.running_mean",
               "backbone.stage_4.out_conv.norm.running_var")
    before = {k: model.state_dict()[k].detach().clone() for k in watched}

    # the main path: counts from 0 just before, read just after
    _cuda.reset_launch_counts()
    losses = []
    for _ in range(TRAIN["warmup"]):
        losses.append(step(state, images, labels, g)["loss"])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN["steps"]):
        losses.append(step(state, images, labels, g)["loss"])
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN["steps"]
    launches = dict(_cuda.LAUNCHES)
    ms = start.elapsed_time(end) / TRAIN["steps"]
    losses = [float(v) for v in losses]
    n_steps = TRAIN["warmup"] + TRAIN["steps"]
    log(f"[train] losses {['%.4f' % v for v in losses]}")
    log(f"[train] {ms:.2f} ms/step, {B / ms * 1e3:.1f} img/s (CUDA events over {TRAIN['steps']} "
        f"steps; host clock {wall_ms:.2f} ms/step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  [{name_power}]")
    log(f"[train] launches in {n_steps} steps: {launches}")
    changed = {k: not torch.equal(v, model.state_dict()[k]) for k, v in before.items()}
    report["train"] = dict(ms_per_step=ms, img_per_s=B / ms * 1e3, host_ms_per_step=wall_ms,
                           losses=losses, launches=launches, changed=changed,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not all(changed.values()):
        raise AssertionError(f"parameters or BN statistics did not change: {changed}")
    if launches["warp_shear3"] != n_steps:
        raise AssertionError(f"K1 launched {launches['warp_shear3']} times in {n_steps} steps")

    # phase 8: one step through K1 vs one through its plain version
    draws = step.sample_draws(g, (B, S, S, 3))
    x_kernel, _ = step.augment(images, labels, draws)
    with plain_warp():
        x_plain, _ = step.augment(images, labels, draws)
    states = [copy.deepcopy(state) for _ in range(2)]
    loss_kernel = float(step(states[0], images, labels, draws=draws)["loss"])
    with plain_warp():
        loss_plain = float(step(states[1], images, labels, draws=draws)["loss"])
    batch_err = (x_kernel.float() - x_plain.float()).abs().max().item()
    loss_rel = abs(loss_kernel - loss_plain) / abs(loss_plain)
    report["train_vs_plain"] = dict(batch_max_abs_err=batch_err, loss_kernel=loss_kernel,
                                    loss_plain=loss_plain, loss_rel=loss_rel)
    log(f"[train] kernel vs plain path, one step from one state and draws: augmented batch "
        f"max|err| {batch_err:.3e} (bound {WARP_BOUND}), loss {loss_kernel:.6f} vs "
        f"{loss_plain:.6f}, rel {loss_rel:.3e} (bound {LOSS_REL_BOUND})")
    if not batch_err <= WARP_BOUND or not loss_rel <= LOSS_REL_BOUND:
        raise AssertionError("the kernel path and the plain path disagree")
    return launches["warp_shear3"]

class Checks:
    """Kernel-vs-plain comparisons of one phase: elementwise tensors by max
    abs error against BOUND[dtype]·max|plain| (bf16 tensors get the bf16
    bound: one bf16 ulp is 2⁻⁸…2⁻⁷ of a value), reduced and weight gradients
    by rel L2 ≤ BWD_REL_L2 (their column sums add block partials with atomics
    in a varying order)."""

    def __init__(self):
        self.rows: list[dict] = []

    def elementwise(self, case: dict, name: str, got: torch.Tensor, want: torch.Tensor) -> float:
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = (got.shape == want.shape and bool(torch.isfinite(got.float()).all())
              and err <= BOUND[want.dtype] * scale)
        self.rows.append(dict(**case, tensor=name, max_abs_err=err, rel=err / max(scale, 1e-30),
                              bound=BOUND[want.dtype], ok=ok))
        return err

    def reduced(self, case: dict, name: str, got: torch.Tensor, want: torch.Tensor,
                ref: torch.Tensor | None = None) -> None:
        err = rel_l2(got, want, ref)
        ok = bool(torch.isfinite(got.float()).all()) and err <= BWD_REL_L2
        self.rows.append(dict(**case, tensor=name, rel_l2=err, bound=BWD_REL_L2, ok=ok))

    def summary(self, case: dict) -> str:
        rows = [r for r in self.rows if all(r.get(k) == v for k, v in case.items())]
        worst = max(rows, key=lambda r: r.get("rel", 0.0) / r["bound"] if "rel" in r
                    else r["rel_l2"] / r["bound"])
        bad = [r["tensor"] for r in rows if not r["ok"]]
        key = "rel" if "rel" in worst else "rel_l2"
        return (f"{len(rows)} tensors, worst {worst['tensor']} {worst[key]:.2e} "
                f"(bound {worst['bound']:.0e}) {'ok' if not bad else 'FAIL ' + str(bad)}")


def compare_backward(report: dict) -> dict[str, float]:
    """Phase 9: the backward-save forwards and the backward kernels vs their
    plain versions at the vit_b_16 shapes (B=8, T=197 and B=3, T=50; f32
    and bf16 x; plain, γ_ls + dp and, for the MLP, a separate residual) and
    at T=512 for attention. One set of saves (the kernel forward's) and one
    dout feed both backward versions. Returns max|dx − plain| of the main
    path's case (B=8, bf16, no γ/dp) per kernel."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(9)
    checks, main_err = Checks(), {}
    cases = [(B, T, dt, v) for B, T in ((8, 197), (3, 50)) for dt in (torch.float32, torch.bfloat16)
             for v in ("plain", "ls+dp", "ls+dp+residual")]
    cases.append((2, 512, torch.bfloat16, "ls+dp"))
    for B, T, dtype, variant in cases:
        extras, res = variant != "plain", variant.endswith("residual")
        kernels = ["block_attention_bwd"] if T == 512 else (
            ["block_mlp_bwd"] + ([] if res else ["block_attention_bwd"]))
        for kernel in kernels:
            case = dict(kernel=kernel, B=B, T=T, dtype=str(dtype).split(".")[-1], variant=variant)
            if kernel == "block_mlp_bwd":
                a = mlp_args(g, B, T, VIT_B["D"], VIT_B["Dh"], dtype, extras, res)
                ops = [a[k] for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")]
                fwd = (a["x"], *ops, a["ls_gamma"], a["dp_scale"], a["residual"])
                want_out, want_saves = bm.fused_mlp_save_plain(*fwd)
                out, saves = bm.fused_mlp_save_cuda(*fwd)
                dout = torch.randn(a["x"].shape, generator=g).to("cuda", dtype)
                bwd = (dout, saves, a["w1"], a["w2"], a["ln_scale"], a["ls_gamma"], a["dp_scale"],
                       res)
                got, want = bm.fused_mlp_bwd_cuda(*bwd), bm.fused_mlp_bwd_plain(*bwd)
                elementwise = ("dx", "dh")
                reduced = ["db1", "db2", "dln_scale", "dln_bias"] + (["dls"] if extras else [])
                y2 = (saves.xhat.float() * a["ln_scale"].float() + a["ln_bias"].float()).bfloat16()
                weights = [("dW1", got.dh, want.dh, y2, a["w1"])]
                fields = bm.MLPSaves._fields
            else:
                a = attn_args(g, B, T, VIT_B["D"], VIT_B["H"], dtype, extras)
                wb = [a[k] for n in "qkvo" for k in (f"w{n}", f"b{n}")]
                fwd = (a["x"], a["ln_scale"], a["ln_bias"], *wb, a["n_heads"], a["ls_gamma"],
                       a["dp_scale"])
                want_out, want_saves = ba.fused_attention_save_plain(*fwd)
                out, saves = ba.fused_attention_save_cuda(*fwd)
                dout = torch.randn(a["x"].shape, generator=g).to("cuda", dtype)
                bwd = (dout, saves, a["wq"], a["wk"], a["wv"], a["wo"], a["ln_scale"],
                       a["ls_gamma"], a["dp_scale"], a["n_heads"])
                got, want = ba.fused_attention_bwd_cuda(*bwd), ba.fused_attention_bwd_plain(*bwd)
                elementwise = ("dx", "dq", "dk", "dv")
                reduced = ["dbq", "dbv", "dbo", "dln_scale", "dln_bias"] + (
                    ["dls"] if extras else [])
                y = (saves.xhat.float() * a["ln_scale"].float() + a["ln_bias"].float()).bfloat16()
                weights = [(f"dW{n}", getattr(got, f"d{n}"), getattr(want, f"d{n}"), y, a[f"w{n}"])
                           for n in "qkv"]
                fields = ba.AttnSaves._fields
            torch.cuda.synchronize()
            checks.elementwise(case, "out", out, want_out)
            for name, s_got, s_want in zip(fields, saves, want_saves):
                if s_want is not None:
                    checks.elementwise(case, name, s_got, s_want)
            for name in elementwise:
                err = checks.elementwise(case, name, getattr(got, name).contiguous(),
                                         getattr(want, name))
                if name == "dx" and (B, T, dtype, variant) == (8, 197, torch.bfloat16, "plain"):
                    main_err[kernel] = err
            for name in reduced:
                checks.reduced(case, name, getattr(got, name), getattr(want, name))
            if kernel == "block_attention_bwd":  # zero in exact arithmetic: rounding noise of ds
                checks.reduced(case, "dbk (vs ‖dbv‖)", got.dbk, want.dbk, ref=want.dbv)
            for name, d_got, d_want, act, w in weights:
                checks.reduced(case, name, bm.weight_grad(d_got, act, w),
                               bm.weight_grad(d_want, act, w))
            log(f"[backward] {kernel:19s} B={B} T={T} {case['dtype']:8s} {variant:15s} "
                f"{checks.summary(case)}")
    report["compare_backward"] = checks.rows
    bad = [r for r in checks.rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} backward comparisons out of bounds: {bad[:8]}")
    return main_err


def time_backward(report: dict) -> dict[str, tuple[float, float]]:
    """Each backward kernel against its plain version, in turns, at the main
    path's shapes (vit_b_16, batch 128, bf16, no γ/dp)."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(10)
    B, T, out, rows = VIT_TRAIN["batch"], 197, {}, []
    m = mlp_args(g, B, T, VIT_B["D"], VIT_B["Dh"], torch.bfloat16, False, False)
    ops = [m[k] for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")]
    _, mlp_saves = bm.fused_mlp_save_cuda(m["x"], *ops)
    dout = torch.randn(m["x"].shape, generator=g).to("cuda", torch.bfloat16)
    mlp = (dout, mlp_saves, m["w1"], m["w2"], m["ln_scale"], None, None, False)
    a = attn_args(g, B, T, VIT_B["D"], VIT_B["H"], torch.bfloat16, False)
    wb = [a[k] for n in "qkvo" for k in (f"w{n}", f"b{n}")]
    _, attn_saves = ba.fused_attention_save_cuda(a["x"], a["ln_scale"], a["ln_bias"], *wb,
                                                 a["n_heads"])
    attn = (dout, attn_saves, a["wq"], a["wk"], a["wv"], a["wo"], a["ln_scale"], None, None,
            a["n_heads"])
    for name, plain, kernel in (
        ("block_mlp_bwd", lambda: bm.fused_mlp_bwd_plain(*mlp),
         lambda: bm.fused_mlp_bwd_cuda(*mlp)),
        ("block_attention_bwd", lambda: ba.fused_attention_bwd_plain(*attn),
         lambda: ba.fused_attention_bwd_cuda(*attn)),
    ):
        plain_ms, ms = alternate(plain, kernel, iters=10)
        rows.append(dict(kernel=name, B=B, T=T, dtype="bfloat16", ms=ms, plain_ms=plain_ms))
        log(f"[time] {name:19s} B={B:3d} T={T} bf16 kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        out[name] = (ms, plain_ms)
    report["backward_times"] = rows
    return out


def vit_step_parts(name: str, cfg: dict, **model_kw):
    """A seeded bf16 classifier on ``name`` (built on the card by default),
    its SGD state and train step (label smoothing 0.1, CutMix⊕MixUp 1.0/0.2),
    uint8 images and labels made on the card, and the step's generator."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.train import (
        ImageClassifier, TrainState, make_train_step, sgd_with_param_groups,
    )

    B, S, classes = cfg["batch"], cfg["img"], cfg["classes"]
    gen = torch.Generator().manual_seed(0)
    backbone = vtt.create_backbone(name, dtype=torch.bfloat16, generator=gen, **model_kw)
    model = ImageClassifier(backbone, classes, dtype=torch.bfloat16, generator=gen)
    opt = sgd_with_param_groups(model, cfg.get("lr", 0.1), momentum=0.9, weight_decay=2e-5)
    step = make_train_step(classes, label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0,
                           compute_dtype=torch.bfloat16)
    data = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randint(0, 256, (B, S, S, 3), dtype=torch.uint8, device="cuda", generator=data)
    labels = torch.randint(0, classes, (B,), device="cuda", generator=data)
    g = torch.Generator(device="cuda").manual_seed(2)
    return TrainState(model, opt), step, images, labels, g


def train_vit(report: dict, name_power: str) -> dict[str, int]:
    """Phase 10 (the transformer training path): the vit_b_16 step at
    bs128@224, 3 warm-up + 10 timed steps, every block through the forward
    and backward kernels; then phase 11, one step through the kernels
    against one through the plain versions from one state and one set of
    draws. Returns the launches of the training run."""
    from vision_toolbox_tpu_torch.ops import _cuda

    cfg = VIT_TRAIN
    state, step, images, labels, g = vit_step_parts("vit_b_16", cfg)
    model, B = state.model, cfg["batch"]
    assert next(model.parameters()).is_cuda, "the default device is the card"
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[vit-train] vit_b_16 + head {cfg['classes']}: {n_params / 1e6:.2f} M f32 params, bf16 "
        f"compute, bs{B}@{cfg['img']}, CutMix⊕MixUp, LS 0.1, SGD 0.9 lr {cfg['lr']}, "
        "wd 2e-5 (3 groups)")
    watched = ("head.weight", "backbone.pe", "backbone.blocks.0.mha.q_proj.weight",
               "backbone.blocks.5.mlp_norm.weight", "backbone.blocks.11.mlp.linear2.bias")
    before = {k: model.state_dict()[k].detach().clone() for k in watched}
    initial = copy.deepcopy(state)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()  # the main path: counts from 0 just before, read just after
    losses = [step(state, images, labels, g)["loss"] for _ in range(cfg["warmup"])]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(cfg["steps"]):
        losses.append(step(state, images, labels, g)["loss"])
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / cfg["steps"]
    launches = dict(_cuda.LAUNCHES)
    ms = start.elapsed_time(end) / cfg["steps"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    n_steps = cfg["warmup"] + cfg["steps"]
    changed = {k: not torch.equal(v, model.state_dict()[k]) for k, v in before.items()}
    log(f"[vit-train] losses {['%.4f' % v for v in losses]}")
    log(f"[vit-train] {ms:.2f} ms/step, {B / ms * 1e3:.1f} img/s (CUDA events over {cfg['steps']} "
        f"steps; host clock {wall_ms:.2f} ms/step); peak memory {peak:.1f} GiB  [{name_power}]")
    log(f"[vit-train] launches in {n_steps} steps: {launches}")
    report["vit_train"] = dict(ms_per_step=ms, img_per_s=B / ms * 1e3, host_ms_per_step=wall_ms,
                               losses=losses, launches=launches, changed=changed, peak_gib=peak)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not all(changed.values()):
        raise AssertionError(f"parameters did not change: {changed}")
    want = {k: 12 * n_steps for k in BLOCK_KERNELS} | {"warp_shear3": 0}
    if launches != want:
        raise AssertionError(f"expected 12 launches of each block kernel per step: {launches}")

    # phase 11: one step through the kernels vs one through the plain
    # versions, from the seeded initial state and one set of draws
    draws = step.sample_draws(g, tuple(images.shape))
    res = kernel_vs_plain_step(initial, step, images, labels, draws)
    report["vit_train_vs_plain"] = res
    loss_rel = abs(res["loss_kernel"] - res["loss_plain"]) / abs(res["loss_plain"])
    worst = sorted(res["grads"].items(), key=lambda kv: -kv[1]["kernel_vs_plain"])[:4]
    wide = {n: r for n, r in res["grads"].items() if r["bound"] > GRAD_REL_L2}
    log(f"[vit-train] kernel vs plain path, one step from the seeded state and one set of draws: "
        f"loss {res['loss_kernel']:.6f} vs {res['loss_plain']:.6f}, rel {loss_rel:.3e} (bound "
        f"{LOSS_REL_BOUND}); gradient rel L2, worst of {len(res['grads'])}: "
        f"{[(n, '%.2e' % r['kernel_vs_plain'], 'bound %.2e' % r['bound']) for n, r in worst]}")
    log(f"[vit-train] {len(wide)} gradients whose plain bf16 version is itself > {GRAD_REL_L2 / 2} "
        f"from the f32 reference (bound 2× that): "
        f"{[(n, '%.2e' % r['plain_vs_f32']) for n, r in list(wide.items())[:8]]}")
    bad = {n: r for n, r in res["grads"].items() if not r["kernel_vs_plain"] <= r["bound"]}
    if not loss_rel <= LOSS_REL_BOUND or bad:
        raise AssertionError(f"the kernel path and the plain path disagree: {bad}")
    return launches


def kernel_vs_plain_step(state, step, images, labels, draws) -> dict:
    """One step through the kernels and one through the plain versions, each
    from a copy of ``state``, and the f32 reference gradient: the same model
    in f32 on the unfused module chain (no bf16 rounding, TF32 off). Every
    parameter's gradient is held to rel L2 ≤ GRAD_REL_L2 against the plain
    path's, or to twice the plain path's own bf16 error where that is larger:
    the softmax backward rounds ds to bf16, and where the keys (queries) of a
    block are nearly alike the query (key) gradient Σ ds·k cancels down to
    that rounding noise, in the JAX kernel as in both versions here; two
    independent bf16 roundings differ by about √2 times either's error. The
    key bias is zero in exact arithmetic, so it is held against the value
    bias."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.train import ImageClassifier, TrainState, sgd_with_param_groups

    states = [copy.deepcopy(state) for _ in range(2)]
    backbone = states[1].model.backbone
    backbone.forward = functools.partial(type(backbone).forward, backbone, plain=True)
    ref_backbone = vtt.create_backbone("vit_b_16")  # f32 compute
    ref_model = ImageClassifier(ref_backbone, VIT_TRAIN["classes"])
    ref_model.load_state_dict(state.model.state_dict())
    ref_backbone.forward = functools.partial(type(ref_backbone).forward, ref_backbone,
                                             force_unfused=True)
    states.append(TrainState(ref_model, sgd_with_param_groups(ref_model, 0.0)))
    losses = [float(step(st, images, labels, draws=draws)["loss"]) for st in states[:2]]
    with plain_attention():
        losses.append(float(step(states[2], images, labels, draws=draws)["loss"]))
    kernel, plain, f32 = ({n: p.grad for n, p in st.model.named_parameters()} for st in states)
    grads = {}
    for n in kernel:
        v = n.replace("k_proj", "v_proj") if n.endswith("k_proj.bias") else None
        own = rel_l2(plain[n], f32[n], f32[v] if v else None)
        grads[n] = dict(kernel_vs_plain=rel_l2(kernel[n], plain[n], plain[v] if v else None),
                        plain_vs_f32=own, bound=max(GRAD_REL_L2, 2 * own))
    return dict(loss_kernel=losses[0], loss_plain=losses[1], loss_f32=losses[2], grads=grads)


def train_deit3(report: dict) -> None:
    """Phase 12: deit3_b_16 (LayerScale 1e-6) with stochastic depth 0.1, a
    few steps at a small batch: the γ_ls and drop-path branches of both
    backward kernels launch and give finite losses and changing parameters,
    the LayerScale γs included."""
    from vision_toolbox_tpu_torch.ops import _cuda

    cfg = DEIT3
    state, step, images, labels, g = vit_step_parts(
        "deit3_b_16", cfg, stochastic_depth=cfg["stochastic_depth"])
    model = state.model
    watched = ("backbone.blocks.0.mha_scale.gamma", "backbone.blocks.11.mlp_scale.gamma",
               "backbone.blocks.6.mha.out_proj.weight", "head.weight")
    before = {k: model.state_dict()[k].detach().clone() for k in watched}
    _cuda.reset_launch_counts()
    losses = [float(step(state, images, labels, g)["loss"]) for _ in range(cfg["steps"])]
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    changed = {k: not torch.equal(v, model.state_dict()[k]) for k, v in before.items()}
    report["deit3_train"] = dict(losses=losses, launches=launches, changed=changed)
    log(f"[deit3] deit3_b_16 bs{cfg['batch']}@{cfg['img']}, stochastic depth "
        f"{cfg['stochastic_depth']}: losses {['%.4f' % v for v in losses]}, launches {launches}, "
        f"changed {changed}")
    if not all(map(math.isfinite, losses)) or not all(changed.values()):
        raise AssertionError("deit3_b_16 training failed")
    if any(launches[k] != 12 * cfg["steps"] for k in BLOCK_KERNELS):
        raise AssertionError(f"expected 12 launches of each block kernel per step: {launches}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.ops.block_attention import _attn_smem_bytes
    from vision_toolbox_tpu_torch.utils.export import export_model, load_exported

    report: dict = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = card()
    report["card"] = name_power
    log(f"[card] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _cuda.library_path()
    _cuda.lib()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {lib_path.relative_to(ROOT)} in {report['build_s']:.1f} s")
    build_log = (lib_path.parent / "build.log").read_text()
    report["build_log"] = build_log
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    for t, hd in ((197, 64), (50, 64), (512, 64), (257, 80)):  # the gate's mirror of the C formula
        c_bytes = _cuda.lib().vtt_attn_smem_bytes(t, hd)
        if c_bytes != _attn_smem_bytes(t, hd):
            raise AssertionError(f"attention smem formula differs at T={t}, hd={hd}")

    # phase 3: kernels vs plain versions
    with torch.inference_mode():
        errors = compare_kernels(report)

    # phase 4: the model, eager, kernels vs plain versions
    model = vtt.create_backbone("vit_b_16", dtype=torch.bfloat16, device="cuda",
                                generator=torch.Generator().manual_seed(0))
    model.eval()
    images = torch.rand(32, 224, 224, 3, generator=torch.Generator().manual_seed(1)).cuda()
    with torch.inference_mode():
        _cuda.reset_launch_counts()
        logits = model(images[:8])
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        plain_logits = model(images[:8], plain=True)
        torch.cuda.synchronize()
    log(f"[model] vit_b_16 bf16 bs8 forward: launches {counts}")
    if counts != {"block_mlp": 12, "block_attention": 12, "block_mlp_bwd": 0,
                  "block_attention_bwd": 0, "warp_shear3": 0}:
        raise AssertionError(f"expected 12 launches of each forward kernel, got {counts}")
    width = model.last_out_channels
    if logits.shape != (8, width) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    err = rel_l2(logits, plain_logits)
    report["model"] = dict(launches=counts, rel_l2_vs_plain=err)
    log(f"[model] logits kernel vs plain path: rel L2 {err:.3e} (bound {REL_L2_BOUND})")
    if not err <= REL_L2_BOUND:
        raise AssertionError(f"logits disagree with the plain path: rel L2 {err}")

    # phase 5: serve — the main path. Counts cover only the served requests.
    t0 = time.perf_counter()
    blob = export_model(model, (8, 224, 224, 3))
    served = load_exported(blob)
    log(f"[serve] export+load {time.perf_counter() - t0:.1f} s, artifact {len(blob) / 2**20:.1f} MiB")
    with torch.inference_mode():
        eager = {b: model(images[:b]) for b in SERVE_BATCHES}
        _cuda.reset_launch_counts()
        answers = {b: [served(images[:b]) for _ in range(3)] for b in SERVE_BATCHES}
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    n_forwards = 3 * len(SERVE_BATCHES)
    log(f"[serve] {n_forwards} requests at batch {SERVE_BATCHES}: launches {launches}")
    if any(launches[k] != 12 * n_forwards for k in SERVE_KERNELS) or any(
            launches[k] for k in ("block_mlp_bwd", "block_attention_bwd")):
        raise AssertionError(f"served path launched {launches}, expected {12 * n_forwards} of "
                             "each forward kernel and no backward kernel")
    serve_rows = []
    for b in SERVE_BATCHES:
        for out in answers[b]:
            e = rel_l2(out, eager[b])
            if out.shape != (b, width) or not torch.isfinite(out.float()).all() or e > 1e-3:
                raise AssertionError(f"served batch {b} disagrees with eager: rel L2 {e}")
        with torch.inference_mode():
            ms = time_ms(lambda: served(images[:b]), iters=10)
        serve_rows.append(dict(batch=b, ms_per_batch=ms, rel_l2_vs_eager=e))
        log(f"[serve] batch {b:2d}: {ms:.3f} ms/batch ({b / ms * 1e3:.1f} img/s), "
            f"rel L2 vs eager {e:.2e}  [{name_power}]")
    report["serve"] = serve_rows

    with torch.inference_mode():
        times = time_kernels(report)

    # phases 6-8: the training path
    with torch.no_grad():
        errors["warp_shear3"], ms, plain_ms = compare_warp(report)
    times["warp_shear3"] = (ms, plain_ms)
    torch.backends.cudnn.benchmark = True
    launches["warp_shear3"] = train(report, name_power)

    # phases 9-12: the transformer training path
    errors |= compare_backward(report)
    times |= time_backward(report)
    vit_launches = train_vit(report, name_power)
    for k in ("block_mlp_bwd", "block_attention_bwd"):
        launches[k] = vit_launches[k]
    train_deit3(report)

    B8, B128, T = 8, VIT_TRAIN["batch"], 197
    work = {
        "block_mlp": block_work("block_mlp", B8, T, 2),
        "block_attention": block_work("block_attention", B8, T, 2),
        "block_mlp_bwd": block_work("block_mlp_bwd", B128, T, 2),
        "block_attention_bwd": block_work("block_attention_bwd", B128, T, 2),
        "warp_shear3": (0.0, 2 * TRAIN["batch"] * TRAIN["img"] ** 2 * 3 * 4),
    }
    kernels = []
    for k in KERNELS:
        bound_ms, bound_by = bound(*work[k])
        kernels.append(dict(name=k, **KERNELS[k], launches=launches[k], max_abs_err=errors[k],
                            ms=times[k][0], plain_ms=times[k][1], bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None))
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": kernels}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
