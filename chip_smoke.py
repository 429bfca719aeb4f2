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
  steps, and one step through K1 against one through its plain version.

Every phase prints what it found; any failure raises and exits non-zero.
Needs a CUDA card: without one it exits 1 and prints no result.

The last three lines are: the kernels as JSON (route, source, the TPU kernel
each replaces, launches in its path's run, error against the plain version,
time of kernel and plain version), the card's name and power limit, and
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json`` beside this file.
"""

from __future__ import annotations

import copy
import contextlib
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
    "warp_shear3": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/warp_shear3.cu",
        "replaces": "vision_toolbox_tpu/ops/warp_pallas.py:166",
    },
}
SERVE_KERNELS = ("block_mlp", "block_attention")
BOUND = {torch.float32: 1e-3, torch.bfloat16: 2e-2}  # × max|plain|
VIT_B = dict(D=768, H=12, Dh=3072)
SERVE_BATCHES = (1, 8, 32)
REL_L2_BOUND = 1e-2
WARP_BOUND = 1e-5  # max abs, [0, 1] images: same f32 operations on both sides
TRAIN = dict(batch=256, img=176, classes=1000, warmup=3, steps=10)
LOSS_REL_BOUND = 1e-3  # kernel-path vs plain-path step: bf16 rounding flips only


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


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


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
    if counts != {"block_mlp": 12, "block_attention": 12, "warp_shear3": 0}:
        raise AssertionError(f"expected 12 launches of each kernel, got {counts}")
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
    if any(launches[k] != 12 * n_forwards for k in SERVE_KERNELS):
        raise AssertionError(f"served path launched {launches}, expected {12 * n_forwards} each")
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

    kernels = [
        dict(name=k, **KERNELS[k], launches=launches[k], max_abs_err=errors[k],
             ms=times[k][0], plain_ms=times[k][1])
        for k in KERNELS
    ]
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
