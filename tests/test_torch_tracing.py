"""The port's spans and counters (``utils/tracing.py``), on the CPU but for
the last test.

- Off (no profiler, no ``recording()``), ``span`` is one shared null context
  and nothing is recorded.
- A vit_ti_16 train step at 32 px through the ``Trainer``, host-fed and from
  the device-resident store, under ``recording()`` and under a CPU
  ``torch.profiler``: ``step`` holds ``draws``, ``input``, ``forward``,
  ``backward`` and ``optim``, ``forward`` one ``block`` a layer, and the
  profiler's events carry the same ranges.
- ``host_syncs`` counts reads of CUDA tensors only; ``_cuda.LAUNCHES`` is the
  registry's ``launches`` section; the epoch record takes the counters'
  ``delta``.
- ``export_model``'s graph is the same with spans on; a loaded program's
  call is ``serve`` ⊃ ``serve.prologue``, ``serve.graph``.
- On the card (``gpu``): one host sync a device-resident step.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import io
import json

import numpy as np
import pytest
import torch

from vision_toolbox_tpu_torch.data.raw_shards import write_shard
from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops.augment import host_rng
from vision_toolbox_tpu_torch.train import config
from vision_toolbox_tpu_torch.train.trainer import Trainer
from vision_toolbox_tpu_torch.utils import tracing
from vision_toolbox_tpu_torch.utils.export import export_model, load_exported

PARTS = {"draws", "input", "forward", "backward", "optim"}
LAYERS = 12  # vit_ti_16


def _trainer(tmp_path, resident: bool, device: str = "cpu", batch: int = 4) -> Trainer:
    cfg = config.Config()
    cfg.model.backbone, cfg.model.num_classes, cfg.model.bf16 = "vit_ti_16", 10, device != "cpu"
    cfg.model.backbone_kwargs = {"img_size": 32}
    cfg.data.batch_size, cfg.data.train_crop_size = batch, 32
    cfg.data.val_crop_size = cfg.data.val_size = 32
    cfg.data.trivial_augment, cfg.data.random_erasing_p = True, 0.5
    cfg.train.epochs, cfg.runtime.out_dir = 1, str(tmp_path / "run")
    if resident:
        rng = np.random.default_rng(0)
        (tmp_path / "train").mkdir()
        n = 4 * batch
        write_shard(str(tmp_path / "train" / "s0.vtraw"),
                    rng.integers(0, 256, (n, 40, 40, 3), np.uint8), rng.integers(0, 10, n))
        cfg.data.train_dir = str(tmp_path / "train")
        cfg.data.raw_shards = cfg.data.device_resident = True
    else:
        cfg.data.synthetic, cfg.data.train_size = True, 2 * batch
    return Trainer(cfg, device=device)


def _parents(spans: dict) -> dict[str, set]:
    return {name: {s.parent for s in group} for name, group in spans.items()}


def test_off_records_nothing():
    tracing.reset()
    first, second = tracing.span("step"), tracing.span("block")
    assert first is second is tracing._NULL
    with first:
        with second:
            pass
    assert tracing.recorded() == {}


@pytest.mark.parametrize("resident", [False, True], ids=["host_fed", "device_resident"])
def test_train_step_spans(tmp_path, resident):
    trainer = _trainer(tmp_path, resident)
    batch = next(iter(trainer._train_feed()))
    with tracing.recording():
        assert tracing.span("x") is not tracing._NULL
        trainer.train_batch(batch)
    spans = tracing.recorded()
    assert len(spans["step"]) == 1 and spans["step"][0].parent is None
    assert PARTS | {"step", "block"} == set(spans)  # no sync: the CPU generator's draw
    parents = _parents(spans)
    assert all(parents[p] == {"step"} for p in PARTS)
    assert len(spans["optim"]) == 2  # zero_grad, then the update
    assert len(spans["block"]) == LAYERS and parents["block"] == {"forward"}
    assert len(spans["draws"]) == 1 and len(spans["input"]) == 1 + resident
    order = [s.name for s in sorted((s for g in spans.values() for s in g if s.parent == "step"),
                                    key=lambda s: s.start_ns)]
    assert order == ["draws", *["input"] * (1 + resident), "optim", "forward", "backward", "optim"]
    step = spans["step"][0]
    assert all(step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
               for g in spans.values() for s in g)


def test_train_step_spans_under_the_profiler(tmp_path):
    """The profiler alone turns the spans on: its events carry the ``vtt:``
    ranges, nested as recorded."""
    trainer = _trainer(tmp_path, resident=True)
    batch = next(iter(trainer._train_feed()))
    tracing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.train_batch(batch)
    assert tracing.span("x") is tracing._NULL
    spans = tracing.recorded()
    assert len(spans["step"]) == 1 and len(spans["block"]) == LAYERS
    events = [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    names = [e.name for e in events]
    assert names.count("vtt:step") == 1 and names.count("vtt:block") == LAYERS
    for e in events:
        if e.name == "vtt:block":
            chain, p = [], e.cpu_parent
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            assert [c for c in chain if c.startswith("vtt:")] == ["vtt:forward", "vtt:step"]


def test_host_syncs_count_cuda_tensors_only():
    before = tracing.snapshot()
    assert tracing.to_host(torch.tensor(3.0)) == 3.0
    host_rng(torch.Generator().manual_seed(0))
    assert tracing.delta(before) == {}

    class OnCard:  # a stand-in for a CUDA tensor
        is_cuda = True

        def tolist(self):
            return [7]

    with tracing.recording():
        assert tracing.to_host(OnCard()) == [7]
    assert tracing.delta(before) == {"host_syncs": 1}
    assert [s.name for s in tracing.recorded()["sync"]] == ["sync"]


def test_launches_are_the_registry_section():
    assert tracing.section("launches") is _cuda.LAUNCHES
    before = tracing.snapshot()
    assert {f"launches/{k}" for k in _cuda.LAUNCHES} | {"host_syncs", "kernel_builds"} \
        == set(before)
    _cuda.LAUNCHES["warp_shear3"] += 2
    tracing.count("kernel_builds")
    assert tracing.delta(before) == {"launches/warp_shear3": 2, "kernel_builds": 1}
    _cuda.reset_launch_counts()
    assert _cuda.LAUNCHES is tracing.section("launches")


def test_epoch_record_takes_the_counters(tmp_path, monkeypatch):
    """The epoch record carries the counters the epoch moved, no others."""
    trainer = _trainer(tmp_path, resident=False)
    inner = trainer.train_step

    def step(*args):
        _cuda.LAUNCHES["block_mlp"] += 12
        return inner(*args)

    monkeypatch.setattr(trainer, "train_step", step)
    trainer.fit()
    epoch = [r for r in _records(trainer) if "epoch_time_s" in r][-1]
    launches = {k: v for k, v in epoch.items() if k.startswith("launches/")}
    assert launches == {"launches/block_mlp": 24}
    assert "host_syncs" not in epoch and "kernel_builds" not in epoch


def _records(trainer):
    path = f"{trainer.cfg.runtime.out_dir}/metrics.jsonl"
    return [json.loads(line) for line in open(path)]


def _nodes(blob: bytes) -> list[str]:
    program = torch.export.load(io.BytesIO(blob))
    return [f"{n.op}:{n.target}" for n in program.graph.nodes]


def test_export_unchanged_and_served_spans():
    model = ViT(192, 2, 3, 16, 32, device="cpu").eval()  # vit_ti_16's width, 2 blocks
    off = export_model(model, (2, 32, 32, 3))
    with tracing.recording():
        on = export_model(model, (2, 32, 32, 3))
    assert tracing.recorded() == {}
    assert _nodes(on) == _nodes(off)
    assert not any("record_function" in n for n in _nodes(on))
    served = load_exported(off)
    x = torch.rand(3, 32, 32, 3)
    want = served(x)
    with tracing.recording():
        got = served(x)
    assert torch.equal(got, want)
    spans = tracing.recorded()
    assert set(spans) == {"serve", "serve.prologue", "serve.graph"}  # no Python blocks
    parents = _parents(spans)
    assert parents["serve.prologue"] == parents["serve.graph"] == {"serve"}
    assert parents["serve"] == {None}
    prologue, graph = spans["serve.prologue"][0], spans["serve.graph"][0]
    assert prologue.end_ns <= graph.start_ns


@pytest.mark.gpu
def test_one_host_sync_a_device_resident_step(tmp_path):
    """On the card: a device-resident step reads the device once, the mix's
    seed (``host_rng``), inside the step's draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests cover the spans and the counting")
    trainer = _trainer(tmp_path, resident=True, device="cuda", batch=8)
    feed = iter(trainer._train_feed())
    trainer.train_batch(next(feed))
    torch.cuda.synchronize()
    before = tracing.snapshot()
    with tracing.recording():
        for _ in range(3):
            trainer.train_batch(next(feed))
    assert tracing.delta(before).get("host_syncs") == 3
    spans = tracing.recorded()
    assert len(spans["sync"]) == 3 and _parents(spans)["sync"] == {"draws"}
