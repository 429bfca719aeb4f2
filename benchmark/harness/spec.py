"""Find a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``) and the
readers of its per-layer metrics (``metrics/<metric>.py``, each with
``read(run) -> float | None``)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict | None
    end_to_end: list[dict]
    per_layer: list[dict]
    bench: Path  # the folder its files came from


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell: str, root: Path = ROOT) -> Cell:
    """The cell ``cell`` of ``root/BENCHMARK.json``, its files under
    ``root/benchmark``."""
    root, bench = Path(root), Path(root) / BENCH.name
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text())
    limits_file = bench / "limits" / f"{cell}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else None
    e2e = [m for m in spec["end_to_end"] if _reports(m, cell)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _reports(m, cell) and m["moves"] in moved]
    return Cell(cell, entry["chips"], config, traffic, limits, e2e, layer, bench)


def reader(metric: str, bench: Path = BENCH):
    """The ``read`` function of ``<bench>/metrics/<metric>.py``."""
    path = Path(bench) / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
