"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vision_toolbox_tpu_torch/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version at the vit_b_16
shapes the model gives it, runs a seeded bf16 vit_b_16 (224 px, random
weights) eagerly and through its plain versions, then serves it: export →
load → requests at batch 1, 8 and 32, each checked against eager. Every
phase prints what it found; any failure raises and exits non-zero. Needs a
CUDA card: without one it exits 1 and prints no result.

The last three lines are: the kernels as JSON (route, source, the TPU kernel
each replaces, launches in the served run, error against the plain version,
time of kernel and plain version at batch 8), the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json`` beside this file.
"""

from __future__ import annotations

import json
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
}
BOUND = {torch.float32: 1e-3, torch.bfloat16: 2e-2}  # × max|plain|
VIT_B = dict(D=768, H=12, Dh=3072)
SERVE_BATCHES = (1, 8, 32)
REL_L2_BOUND = 1e-2


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
    if counts != {"block_mlp": 12, "block_attention": 12}:
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
    if any(launches[k] != 12 * n_forwards for k in KERNELS):
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
