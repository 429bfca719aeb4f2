"""The per-layer metrics that read the program's own spans
(``vision_toolbox_tpu_torch/utils/tracing.py``): their entries in
BENCHMARK.json, their arithmetic on synthetic contexts, and a traced run of
each cell of the tiny root on the CPU, where no device time exists: every
reader returns a number or None and raises nothing."""

import pytest

import tiny
from benchmark import run as bench_run
from benchmark.harness import flops, spec, trace

TRAIN, SERVE = "vit_b_16.train.b128", "vit_b_16.serve.b256"
NEW = {TRAIN: ["input_span_ms.train", "optim_span_ms.train", "blocks_span_roofline.train",
               "host_syncs.train"],
       SERVE: ["prologue_ms.serve"]}
VIT = dict(reference="vit", num_layers=12, hidden_size=768, mlp_dim=3072, num_heads=12,
           patch_size=16, image_size=224, num_classes=1000)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def test_entries_are_found():
    for cell, names in NEW.items():
        per_layer = {m["name"]: m for m in spec.load(cell).per_layer}
        assert set(names) <= set(per_layer)
        assert all(per_layer[n]["workloads"] == [cell] for n in names)


def test_span_readers_on_synthetic_contexts():
    step = ("vtt:step", "bench:step")
    block = ("aten::mm", "vtt:block", "vtt:forward", "bench:blocks", "bench:model") + step
    kernels = [trace.Kernel("gemm", 0.004, block),
               trace.Kernel("gemm_bwd", 0.008, ("aten::mm", trace.BACKWARD) + block),
               trace.Kernel("warp", 0.001, ("aten::copy_", "vtt:input") + step),
               trace.Kernel("rand", 0.0002, ("aten::uniform_", "vtt:draws") + step),
               trace.Kernel("loss", 0.0005, ("aten::log_softmax", "vtt:forward") + step),
               trace.Kernel("sgd", 0.002, ("aten::_foreach_add_", "vtt:optim", "bench:optim")
                            + step)]
    tr = trace.Trace(units=2, window_s=0.03, busy_s=0.0155, kernels=kernels, intervals=[])
    run = {"trace": tr, "steps": 50, "window_s": 0.6, "batch": 128, "arch": VIT}
    read = lambda name: spec.reader(name)(run)  # noqa: E731
    assert read("input_span_ms.train") == pytest.approx(0.6)  # the warp and the draws
    assert read("optim_span_ms.train") == pytest.approx(1.0)
    least = flops.vit_blocks_least_seconds(VIT, 128, True)
    assert read("blocks_span_roofline.train") == pytest.approx(100 * 2 * least / 0.012)
    # the outside twins read the same steps alike
    assert spec.reader("optim_ms.train")(run) == read("optim_span_ms.train")
    assert spec.reader("blocks_roofline.train")(run) == read("blocks_span_roofline.train")
    # nothing under the program's spans (an earlier program): no value, never 0
    bare = [trace.Kernel(k.name, k.seconds, tuple(c for c in k.context if "vtt:" not in c))
            for k in kernels]
    run["trace"] = trace.Trace(units=2, window_s=0.03, busy_s=0.0155, kernels=bare, intervals=[])
    for name in NEW[TRAIN][:3]:
        assert read(name) is None


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_traced_run_reads(root, cell):
    from vision_toolbox_tpu_torch.utils import tracing

    c = spec.load(cell, root)
    dev = bench_run.Device("cpu")
    run = bench_run.measure(c, 123456789012, 0.5, True, dev)
    line = bench_run.result(c, run, True, dev)
    values = {name: spec.reader(name, c.bench)(run) for name in NEW[cell]}
    assert all(v is None or isinstance(v, float) for v in values.values()), values
    spans = tracing.recorded()
    if cell == TRAIN:
        # the CPU generator's draw reads no device; no device time on the CPU
        assert len(spans["step"]) == run["trace"].units == 3
        assert values == {"input_span_ms.train": None, "optim_span_ms.train": None,
                          "blocks_span_roofline.train": None, "host_syncs.train": 0.0}
        assert line["metrics"]["host_syncs.train"] == {"value": 0.0, "unit": "syncs/step"}
    else:
        assert len(spans["serve.prologue"]) == run["trace"].units
        assert values["prologue_ms.serve"] > 0
        assert "prologue_ms.serve" in line["metrics"]
    tracing.reset()  # a program without the spans: nothing to read
    assert all(spec.reader(n, c.bench)(run) is None for n in NEW[cell]
               if n in ("host_syncs.train", "prologue_ms.serve"))
