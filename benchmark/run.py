"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` times
the window the same way, then profiles a short fixed sub-window and prints
the cell's per-layer metrics. Both check the first steps or a sample of the
requests against the plain reference (``correct``) and print each number
compared beside its limit, last on standard error and last in the result.
Needs as many CUDA devices as the cell asks for; exits non-zero, printing no
result, without them, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the program's build and kernel caches: fixed directories inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BENCH / "_work" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH / "_work" / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "vision_toolbox_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Device:
    def __init__(self, device):
        import torch

        self.torch, self.device = torch, torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def free(self) -> None:
        import gc

        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


def measure(cell, seed: int, seconds: float, do_trace: bool, dev: Device,
            fault: str | None = None) -> dict:
    """Run the cell's driver (``harness/<kind>.py``)."""
    import importlib

    driver = importlib.import_module(f"benchmark.harness.{cell.traffic['kind']}")
    return driver.run(cell, seed, seconds, do_trace, dev, T_START, fault)


def result(cell, run: dict, do_trace: bool, dev: Device) -> dict:
    """The result line: ``correct`` and the metrics of the cell for this
    mode, the device, the breakdown when traced, the checks last."""
    from benchmark.harness import compare, spec

    correct, checks = compare.judge(run["numbers"], cell.limits)
    metrics = {}
    if do_trace:
        for m in cell.per_layer:
            value = spec.reader(m["name"], cell.bench)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = spec.reader(m["name"], cell.bench)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    torch = dev.torch
    device = {"platform": "gpu" if dev.cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev.device) if dev.cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": run["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": run.get("requests", run.get("steps")),
            "failed": 0, "metrics": metrics, "device": device}
    if do_trace:
        tr = run["trace"]
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops(10),
                             "idle_gaps": [[n, s] for n, s in tr.idle_gaps[:10]]}
    line["checks"] = checks
    return line


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import spec

    cell = spec.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    print(f"card: {card.stdout.strip() or card.stderr.strip()}", file=sys.stderr)
    dev = Device("cuda")
    run = measure(cell, args.seed, args.seconds, bool(args.trace), dev)
    line = result(cell, run, bool(args.trace), dev)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
