"""A copy of the benchmark at CPU size: the same BENCHMARK.json, metrics and
limits, with configurations and traffic cut to a few small images, under a
temporary root."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def tiny_root(tmp: Path) -> Path:
    """A root holding BENCHMARK.json and benchmark/{configs, traffic,
    limits, metrics}: vit_ti_16 at 32 px, trained in batches of 8 and
    served at batch 4."""
    bench = tmp / "benchmark"
    for d in ("configs", "traffic"):
        (bench / d).mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    shutil.copytree(BENCH / "limits", bench / "limits")
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for path in (BENCH / "configs").glob("*.json"):
        cfg = _read(path)
        cfg["architecture"].update(backbone="vit_ti_16", hidden_size=192, mlp_dim=768,
                                   num_heads=3, image_size=32)
        cfg["recipe"]["model"].update(backbone="vit_ti_16", backbone_kwargs={"img_size": 32})
        cfg["recipe"]["data"]["train_crop_size"] = 32
        cfg["batch_size"] = 8
        if "store_px" in cfg:
            cfg["store_px"] = 40
        (bench / "configs" / path.name).write_text(json.dumps(cfg))
    cut = {"store_images": 64, "batch_sizes": [4],
           "pool_per_size": 2, "sample_every": 4, "profiled_rounds": 1, "warmup_per_size": 1}
    for path in (BENCH / "traffic").glob("*.json"):
        traffic = _read(path)
        traffic.update({k: v for k, v in cut.items() if k in traffic})
        (bench / "traffic" / path.name).write_text(json.dumps(traffic))
    return tmp


def measure(root: Path, cell_name: str, seed: int = 123456789012, fault: str | None = None,
            seconds: float = 1.0) -> tuple[object, dict, dict]:
    """Drive one run of ``cell_name`` on the CPU past the harness's look for
    a card. Returns (cell, run, result line)."""
    from benchmark import run as bench_run
    from benchmark.harness import spec

    cell = spec.load(cell_name, root)
    dev = bench_run.Device("cpu")
    run = bench_run.measure(cell, seed, seconds, False, dev, fault)
    return cell, run, bench_run.result(cell, run, False, dev)
