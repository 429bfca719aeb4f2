"""What the port's spans cost and what they see without a profiler: a
benchmark cell run whole (``benchmark/harness``: set-up, the timed window,
the check against the plain reference) with the spans off, then inside
``tracing.recording()``, in turns in one process (off, on, on, off, ...),
each run's end-to-end metrics printed beside a summary of the spans the
recording holds (per span: count, median, 95th percentile and total host ms;
the syncs and serve calls per step or request).

    python3 scripts/tracing_cost.py [--cell vit_b_16.train.b128 ...] [--turns 2]
        [--seconds 20] [--seed 1234567890123]

A pair of runs (off, on) shares a seed. Needs a CUDA card; prints one JSON
line per run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def summary(spans: dict) -> dict:
    out = {}
    for name, group in sorted(spans.items()):
        ms = sorted((s.end_ns - s.start_ns) / 1e6 for s in group)
        out[name] = {"n": len(ms), "median_ms": statistics.median(ms),
                     "p95_ms": ms[min(len(ms) - 1, int(0.95 * len(ms)))], "total_ms": sum(ms)}
    return out


def one_run(cell_name: str, seed: int, seconds: float, on: bool) -> dict:
    import contextlib

    from benchmark import run as bench_run
    from benchmark.harness import spec
    from vision_toolbox_tpu_torch.utils import tracing

    cell = spec.load(cell_name)
    dev = bench_run.Device("cuda")
    tracing.reset()
    before = tracing.snapshot()
    with tracing.recording() if on else contextlib.nullcontext():
        run = bench_run.measure(cell, seed, seconds, False, dev)
    line = bench_run.result(cell, run, False, dev)
    out = {"cell": cell_name, "spans_on": on, "seed": seed, "correct": line["correct"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "counters": tracing.delta(before)}
    spans = tracing.recorded()
    if spans:
        out["spans"] = summary(spans)
        unit = "step" if "step" in spans else "serve"
        n = len(spans.get(unit, ())) or 1
        out[f"syncs_per_{unit}"] = len(spans.get("sync", ())) / n
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", nargs="+", default=["vit_b_16.train.b128", "vit_b_16.serve.b256"])
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1234567890123)
    args = p.parse_args(argv)
    for cell in args.cell:
        order = [False, True, True, False] * ((args.turns + 1) // 2)
        for i, on in enumerate(order[:2 * args.turns]):
            t0 = time.perf_counter()
            line = one_run(cell, args.seed + i // 2, args.seconds, on)
            line["run_s"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
