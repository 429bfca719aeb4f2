"""The benchmark is found by name in files: a cell, a configuration, a
traffic mix and a per-layer metric added as files alone are run; and
BENCHMARK.json keeps the contract's shape."""

import json
import re
import sys

import pytest

import tiny
from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    s = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in names
    for c in s["configs"]:
        assert (tiny.ROOT / c["file"]).is_file() and NAME.match(c["name"])
    cells = {w["name"] for w in s["workloads"]}
    for w in s["workloads"]:
        assert (tiny.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (tiny.BENCH / "limits" / f"{w['name']}.json").is_file()
        cell = spec.load(w["name"])
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in s["end_to_end"] + s["per_layer"]:
        assert (tiny.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in s["per_layer"]:
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}


def test_added_files_are_found(tmp_path):
    root = tiny.tiny_root(tmp_path)
    bench = root / "benchmark"
    s = json.loads((root / "BENCHMARK.json").read_text())
    # a new configuration, traffic mix, cell and per-layer metric: files and entries only
    cfg = json.loads((bench / "configs" / "vit_b_16.json").read_text())
    cfg["batch_size"] = 4
    (bench / "configs" / "vit_small_batch.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "train_resident.json").read_text())
    traffic["store_images"] = 32
    (bench / "traffic" / "train_small.json").write_text(json.dumps(traffic))
    (bench / "limits" / "vit_small_batch.train.b4.json").write_text(
        (bench / "limits" / "vit_b_16.train.b128.json").read_text())
    (bench / "metrics" / "steps_done.train.py").write_text(
        "def read(run):\n    return float(run['steps']) if 'steps' in run else None\n")
    s["configs"].append({"name": "vit_small_batch", "source": "https://arxiv.org/abs/2010.11929",
                         "file": "benchmark/configs/vit_small_batch.json", "reduced": [],
                         "why": "test"})
    s["workloads"].append({"name": "vit_small_batch.train.b4", "config": "vit_small_batch",
                           "traffic": "train_small", "chips": 1, "why": "test"})
    s["per_layer"].append({"name": "steps_done.train", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "train step",
                           "moves": "train_ips", "workloads": ["vit_small_batch.train.b4"]})
    for m in s["end_to_end"] + s["per_layer"]:
        if m["name"] in ("train_ips", "mfu.train", "input_ms.train", "optim_ms.train",
                         "idle.train"):
            m["workloads"].append("vit_small_batch.train.b4")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    cell, run, line = tiny.measure(root, "vit_small_batch.train.b4")
    assert run["batch"] == 4 and run["steps"] > 0
    assert "steps_done.train" in [m["name"] for m in cell.per_layer]
    assert spec.reader("steps_done.train", cell.bench)(run) == run["steps"]
    assert set(line["metrics"]) == {"train_ips", "setup_s"}  # no device memory on the CPU


def test_forbidden_modules_compared_whole(monkeypatch):
    from benchmark import run as bench_run

    monkeypatch.setitem(sys.modules, "vision_toolbox_tpu_torch_like", object())
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "vision_toolbox_tpu.models", object())
    assert bench_run.forbidden_modules() == ["jax", "vision_toolbox_tpu"]


def test_no_card_no_result(capsys):
    from benchmark import run as bench_run

    if __import__("torch").cuda.is_available():
        pytest.skip("this test reads the refusal of a machine without a card")
    assert bench_run.main(["--workload", "vit_b_16.train.b128", "--seed", "1", "--seconds",
                           "1"]) != 0
    assert capsys.readouterr().out == ""
