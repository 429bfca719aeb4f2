"""A/B of the three-shear warp kernel (K1) against other builds of it, on one NVIDIA card.

    python3 scripts/ab_warp.py [--parent DIR] [--variant NAME=DIR ...] [--step]

``DIR`` holds another build's ``warp_shear3.cu``: ``--parent`` an earlier
revision (``git show <rev>:vision_toolbox_tpu_torch/csrc/warp_shear3.cu``),
a ``--variant`` a copy of this checkout's with a constant or a rule edited.
All keep the C interface ``vtt_warp_shear3(x, out, flags, coef, B, H, W, C,
S, P, stream)``. Each is compiled with nvcc into a temporary directory (all
builds at once, its C entry renamed ``vtt_warp_shear3_<name>`` so that it
has a namespace of its own) and loaded beside this checkout's kernels, so
all run in one process on one card; the registers and spills ptxas reports
for each build's kernels are printed.

Cases at bs256@176 f32, NHWC with C = 3 (the cspdarknet53 recipe's batch):
``chip_smoke.warp_case``'s mixed program (phase 6's), and one kind of
program a batch (``chip_smoke.WARP_KINDS``): all identity, all shear X, all
shear Y, all translate, all rotate by ±45° (|mag| = 1/3, k90 = 0) and all
rotate by ±135° (|mag| = 1, k90 = ±1). For each: every build's output
against the plain version and this checkout's, as the count of differing
elements (0: K1 forms every value with the plain version's f32 operations);
the kernel alone (the program's operands made once), other build, this,
this, other build, as CUDA-event means of ``ITERS`` calls; device time a
call by torch.profiler; the bound (bytes: the batch read once and written
once over 3.35 TB/s) and each time's share of it. With ``--step``, also the
full-recipe cspdarknet53 step at bs256@176 (cell (b), ``chip_smoke.train``'s
setup) with each other build's K1 in place of this checkout's, in turns
(other, this, this, other; ``STEP_WARMUP`` + ``STEP_ITERS`` steps each, CUDA
events and the host clock), and K1's device time in a traced step.

Prints one line per timing and one JSON line; writes
``chiprun_out/ab_warp.json``; exits 1 if any build differs from the plain
version anywhere. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
BATCH, SIZE = 256, 176
ITERS = 50
PROFILED = 10
STEP_WARMUP, STEP_ITERS = 3, 10
PEAK_BYTES_PER_S = 3.35e12


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
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


def device_ms(fn, calls: int = PROFILED, pattern: str = r"warp_shear3_kernel") -> float | None:
    """Device ms a call of the kernels whose names match ``pattern`` among
    those ``fn`` launches (torch.profiler; a ctypes launch is read from the
    device events, it is linked to no CPU op); None where two traces in a
    row caught no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        found = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and re.search(pattern, e.name)]
        if found:
            return sum(found) / calls
    return None


def ptxas(log: str) -> list[str]:
    """ptxas's registers and spills of the K1 kernels in a build log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(warp_shear3_kernel)(I\w+?E)?", m.group(1))
            entry = None if k is None else k.group(1) + (k.group(2) or "")
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split('ptxas info', 1)[-1].strip(' :')}")
    return out


def start_build(name: str, src: Path) -> tuple[Path, subprocess.Popen]:
    """Start nvcc on another build of K1, a shared library outside the checkout."""
    from vision_toolbox_tpu_torch.ops import _cuda

    out = Path(tempfile.mkdtemp(prefix=f"k1_{name}_")) / "libk1.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-Dvtt_warp_shear3=vtt_warp_shear3_{name}",
           "-shared", "-o", str(out), str(src / "warp_shear3.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_build(name: str, out: Path, proc: subprocess.Popen):
    """Wait for a build started by start_build; its C entry and ptxas lines."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
    fn = getattr(ctypes.CDLL(str(out)), f"vtt_warp_shear3_{name}")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
    fn.restype = I
    return fn, ptxas(log)


def launcher(entry, x, flags, coef):
    """A call of a K1 entry on x with the program's operands, into a buffer
    made here; returns (call, out)."""
    from vision_toolbox_tpu_torch.ops import warp

    B, H, W, C = x.shape
    S = warp.canvas_size(H)
    out = torch.empty_like(x)

    def call():
        err = entry(x.data_ptr(), out.data_ptr(), flags.data_ptr(), coef.data_ptr(), B, H, W, C,
                    S, (S - H) // 2, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    return call, out


def run_case(label, x, op, mag, builds, report, name_power):
    from vision_toolbox_tpu_torch.ops import _cuda, warp

    program = warp.shear3_params(op, mag)
    flags, coef = warp.program_operands(program)
    want = warp.shear3_warp_plain(x, program)
    this_call, this_out = launcher(_cuda.lib().vtt_warp_shear3, x, flags, coef)
    this_call()
    torch.cuda.synchronize()
    bound = 2 * x.numel() * 4 / PEAK_BYTES_PER_S * 1e3
    row = {"k90": sorted(set(program[0].tolist())), "bound_ms": bound,
           "this": {"differing_vs_plain": int((this_out != want).sum().item())}, "others": {}}
    for name, entry in builds:
        call, out = launcher(entry, x, flags, coef)
        call()
        torch.cuda.synchronize()
        o = {"differing_vs_plain": int((out != want).sum().item()),
             "differing_vs_this": int((out != this_out).sum().item())}
        e1, n1, n2, e2 = time_ms(call), time_ms(this_call), time_ms(this_call), time_ms(call)
        o |= dict(ms=(e1 + e2) / 2, this_ms=(n1 + n2) / 2, runs=[e1, n1, n2, e2],
                  device_ms=device_ms(call), this_device_ms=device_ms(this_call))
        o["share_of_bound"] = bound / o["ms"]
        print(f"[ab] {label} {name}: {name} {e1:.4f} / {e2:.4f} ms, this {n1:.4f} / {n2:.4f} ms; "
              f"device {o['device_ms']} / {o['this_device_ms']}; differing vs plain "
              f"{o['differing_vs_plain']}, vs this {o['differing_vs_this']}  [{name_power}]",
              flush=True)
        row["others"][name] = o
    ms = time_ms(this_call)
    row["this"] |= dict(ms=ms, device_ms=device_ms(this_call), share_of_bound=bound / ms)
    print(f"[ab] {label} this: {ms:.4f} ms (device {row['this']['device_ms']}), bound "
          f"{bound:.4f} ms, {bound / ms:.1%} of it; {row['this']['differing_vs_plain']} "
          f"differing vs plain; k90 {row['k90']}  [{name_power}]", flush=True)
    report["cases"][label] = row


def step_in_turns(builds, report, name_power):
    """Cell (b): the cspdarknet53 step with each other build's K1 in place of
    this checkout's, in turns."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.ops import _cuda, warp
    from vision_toolbox_tpu_torch.train import (
        ImageClassifier, TrainState, make_train_step, sgd_with_param_groups,
        warmup_cosine_schedule,
    )
    import chip_smoke

    cfg = chip_smoke.TRAIN
    B, S, classes = cfg["batch"], cfg["img"], cfg["classes"]
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
    this_cuda = warp.shear3_warp_cuda

    def other_cuda(entry):
        def run(x, program):
            flags, coef = warp.program_operands(program)
            call, out = launcher(entry, x.contiguous(), flags, coef)
            call()
            _cuda.LAUNCHES["warp_shear3"] += 1
            return out
        return run

    def timed(fn):
        warp.shear3_warp_cuda = fn
        try:
            for _ in range(STEP_WARMUP):
                step(state, images, labels, g)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(STEP_ITERS):
                step(state, images, labels, g)
            end.record()
            end.synchronize()
            host = (time.perf_counter() - t0) * 1e3 / STEP_ITERS
            k1 = device_ms(lambda: step(state, images, labels, g), calls=2)
            return start.elapsed_time(end) / STEP_ITERS, host, k1
        finally:
            warp.shear3_warp_cuda = this_cuda

    rows = {}
    for name, entry in builds:
        runs = [timed(other_cuda(entry)), timed(this_cuda), timed(this_cuda),
                timed(other_cuda(entry))]
        rows[name] = dict(ms=[r[0] for r in runs], host_ms=[r[1] for r in runs],
                          k1_device_ms=[r[2] for r in runs], order=[name, "this", "this", name])
        print(f"[step] cspdarknet53 bs{B}@{S} ({name}, this, this, {name}): ms/step "
              + " / ".join(f"{r[0]:.2f}" for r in runs) + "; host " +
              " / ".join(f"{r[1]:.2f}" for r in runs) + "; K1 in the step " +
              " / ".join(str(r[2]) for r in runs) + f"  [{name_power}]", flush=True)
    report["step"] = rows


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_warp: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    parser.add_argument("--step", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from vision_toolbox_tpu_torch.ops import _cuda

    torch.backends.cudnn.allow_tf32 = False
    name_power = card()
    print(f"[card] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _cuda.lib()
    this_ptxas = ptxas((_cuda.library_path().parent / "build.log").read_text())
    report = {"card": name_power, "this": {"ptxas": this_ptxas}, "others": {}, "cases": {}}
    print(f"[ptxas] this: {'; '.join(this_ptxas)}", flush=True)
    started = [(name, *start_build(name, Path(src)))
               for name, src in ([("parent", args.parent)] if args.parent else [])
               + [tuple(v.split("=", 1)) for v in args.variant]]
    builds = []
    for name, out, proc in started:
        entry, regs = load_build(name, out, proc)
        report["others"][name] = {"ptxas": regs}
        print(f"[ptxas] {name}: {'; '.join(regs)}", flush=True)
        builds.append((name, entry))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        run_case("mixed", *chip_smoke.warp_case(g, BATCH, SIZE), builds, report, name_power)
        for kind in chip_smoke.WARP_KINDS:
            run_case(kind, *chip_smoke.warp_kind_case(g, BATCH, SIZE, kind), builds, report,
                     name_power)
            torch.cuda.empty_cache()
    if args.step:
        step_in_turns(builds, report, name_power)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_warp.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    bad = [(label, who) for label, row in report["cases"].items()
           for who, r in [("this", row["this"]), *row["others"].items()]
           if r["differing_vs_plain"]]
    if bad:
        print(f"ab_warp: builds differ from the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
