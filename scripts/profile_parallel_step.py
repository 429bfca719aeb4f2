"""Where the time of the port's sharded vit_b_16 step goes at world 1, on
one NVIDIA card.

    python3 scripts/profile_parallel_step.py [--steps 10] [--profiled 3]

Builds ``chip_smoke.py`` phase 53's three steps of vit_b_16 at bs128@224
(bf16 compute, f32 parameters, CutMix⊕MixUp, SGD; ``chip_smoke.TP_FSDP``):
replicated, tp on ``{"data": 1, "model": 1}`` and fsdp on ``{"data": 1}``
(``parallel/sharding.py`` gather-at-use, every shard whole, through a
one-rank NCCL world on 127.0.0.1). Each runs alone, its state built, timed
and freed before the next (CUDA events over ``--steps`` steps after 3, the
host clock beside), then traced over ``--profiled`` steps with
``torch.profiler``: the device's busy time (the union of kernels, copies
and sets) against the window, the NCCL kernels' count and time, the copies'
and the rest. Then the three are built together and timed in turns
(replicated, tp, fsdp, fsdp, tp, replicated), as phase 53 times them.
Prints one line a measurement and one JSON line; writes
``chiprun_out/profile_parallel_step.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

KINDS = ("replicated", "tp", "fsdp")


def build(kind: str):
    """(step closure, number of parameters sharded) of ``kind``."""
    from vision_toolbox_tpu_torch.parallel import create_mesh, shard_train_state
    from vision_toolbox_tpu_torch.parallel.sharding import shard_of
    from vision_toolbox_tpu_torch.train import shard_train_step

    state, step, images, labels, g = chip_smoke.vit_step_parts("vit_b_16", chip_smoke.TP_FSDP)
    if kind != "replicated":
        mesh = (create_mesh(("data", "model"), (1, 1)) if kind == "tp"
                else create_mesh(("data",), (1,)))
        shard_train_state(state, mesh, fsdp=kind == "fsdp")
        step = shard_train_step(step, mesh)
    sharded = sum(shard_of(p) is not None for p in state.model.parameters())
    return (lambda: step(state, images, labels, g)), sharded


def timed(run, steps: int) -> tuple[float, float]:
    """(CUDA-event ms, host ms) a step over ``steps`` after 3."""
    t0 = time.perf_counter()
    ms = chip_smoke.time_ms(run, iters=steps)
    return ms, (time.perf_counter() - t0) * 1e3 / (steps + 3)


def traced(run, steps: int) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    path = ROOT / "chiprun_out" / "parallel_trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    nccl = [e for e in device if "nccl" in e.get("name", "").lower()]
    copies = [e for e in device if e.get("cat") != "kernel"]
    trace = chip_smoke.trace_device(path)
    path.unlink()
    us = lambda es: sum(e["dur"] for e in es)
    return dict(window_ms=trace["window_us"] / 1e3 / steps,
                busy_ms=trace["busy_us"] / 1e3 / steps,
                idle=1 - trace["busy_us"] / trace["window_us"],
                nccl_kernels=len(nccl) / steps, nccl_ms=us(nccl) / 1e3 / steps,
                copies=len(copies) / steps, copies_ms=us(copies) / 1e3 / steps,
                kernels=trace["kernels"] / steps)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--profiled", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_parallel_step: no CUDA device", file=sys.stderr)
        return 1
    from vision_toolbox_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    name_power = chip_smoke.card()
    _cuda.lib()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    report: dict = {"card": name_power, "alone": {}, "in_turns": {}}
    with chip_smoke.one_rank_world():
        for kind in KINDS:
            run, sharded = build(kind)
            ms, host_ms = timed(run, args.steps)
            prof = traced(run, args.profiled)
            report["alone"][kind] = dict(ms=ms, host_ms=host_ms, sharded=sharded, **prof)
            print(f"[alone] vit_b_16 {kind}: {sharded} sharded; {ms:.2f} ms a step (CUDA "
                  f"events), host {host_ms:.2f}; traced: window {prof['window_ms']:.2f}, busy "
                  f"{prof['busy_ms']:.2f} (idle {prof['idle']:.3f}), {prof['kernels']:.0f} "
                  f"kernels, NCCL {prof['nccl_kernels']:.0f} kernels {prof['nccl_ms']:.3f} ms, "
                  f"copies {prof['copies']:.0f} {prof['copies_ms']:.3f} ms a step  "
                  f"[{name_power}]", flush=True)
            del run
            gc.collect()
            torch.cuda.empty_cache()
        runs = {kind: build(kind)[0] for kind in KINDS}
        for kind in (*KINDS, *reversed(KINDS)):
            ms, host_ms = timed(runs[kind], args.steps)
            report["in_turns"].setdefault(kind, []).append(dict(ms=ms, host_ms=host_ms))
        for kind in KINDS:
            turns = report["in_turns"][kind]
            print(f"[in turns] vit_b_16 {kind}: " + ", ".join(
                f"{t['ms']:.2f} ms (host {t['host_ms']:.2f})" for t in turns)
                + f"  [{name_power}]", flush=True)
    (ROOT / "chiprun_out" / "profile_parallel_step.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
