"""The port's trainer, config and CLI (vision_toolbox_tpu_torch/train/
trainer.py, config.py, __main__.py) vs the JAX package's, on the CPU.

- ``load_config`` gives the JAX package's merged dict for every file under
  configs/, and composes files and ``--set`` overrides as the JAX tests hold
  it (tests/test_trainer.py:171-192).
- Trainer parity: the JAX test's smoke config (darknet19, 10 classes,
  bs16@32, f32, synthetic data) with no TrivialAugment, erasing or mix, so
  that neither run draws anything: the JAX Trainer's initial variables are
  copied into the port's model, both fit one epoch (10 steps), and every
  record of metrics.jsonl agrees (train/loss and val/loss rel ≤ 1e-4, lr
  within 1e-7, val/acc and val/acc5 within 1e-6: f32 with the JAX side's
  batch sharded over 8 CPU devices, so sums run in another order). The
  parameters and BatchNorm statistics after the first step agree tensor by
  tensor (rel L2 ≤ 1e-4; measured ≤ 1.2e-5, the BN biases, whose gradients
  pass leaky-ReLU kinks that f32 noise flips). The final ones are held
  taken together at rel L2 ≤ 1e-3: both runs memorize the one synthetic
  batch down to the label-smoothing floor (loss 0.51 from step 6), where
  the gradient is a small residual and the runs drift apart about 4× a
  step (measured 2.5e-7 after step 1, 4.2e-7 after 3, 7.4e-5 after 6,
  3.3e-4 after 10), while the logged losses still agree to 1e-4.
- The port's own behaviours: resume (bit-equal state, 2 epochs straight =
  1 + resume + 1), start_epoch, metrics.jsonl truncated on a fresh start and
  appended on a resume, best/, echo, the ragged val batch, the val cache,
  SIGTERM, the refused meta mismatch, the drop overrides, the
  device-resident store, the CLI, the refused parallel configurations and
  the default device.
"""

import json
import os
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax

from vision_toolbox_tpu.train import config as jconfig
from vision_toolbox_tpu.train.trainer import Trainer as JaxTrainer
from vision_toolbox_tpu_torch.data.raw_shards import write_shard
from vision_toolbox_tpu_torch.train import config
from vision_toolbox_tpu_torch.train import trainer as trainer_mod
from vision_toolbox_tpu_torch.train.__main__ import main as cli_main
from vision_toolbox_tpu_torch.train.trainer import Trainer
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs").glob("*.yaml"))
REL = 1e-4


def _smoke(cfg, tmp_path, name="run", steps=None):
    """tests/test_trainer.py's ``_smoke_cfg``, on either package's Config."""
    cfg.model.backbone = "darknet19"
    cfg.model.num_classes = 10
    cfg.model.bf16 = False
    cfg.data.synthetic = True
    cfg.data.batch_size = 16
    cfg.data.train_crop_size = 32
    cfg.data.val_crop_size = 32
    cfg.data.trivial_augment = False
    cfg.data.random_erasing_p = 0.0
    cfg.train.epochs = 1
    cfg.train.warmup_epochs = 1
    cfg.runtime.out_dir = str(tmp_path / name)
    cfg.runtime.log_every = 5
    if steps is not None:
        cfg.data.train_size = 16 * steps
    return cfg


def _cfg(tmp_path, name="run", steps=3, **train):
    """The smoke config on a small backbone (0.9 M parameters: a fit writes
    checkpoints of a few MB, where darknet19's are 160 MB each)."""
    cfg = _smoke(config.Config(), tmp_path, name, steps)
    cfg.model.backbone = "mobilenet_v3_small"
    cfg.runtime.log_every = 1
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _records(cfg):
    with open(os.path.join(cfg.runtime.out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_load_config_matches_jax(path):
    overrides = ["train.lr=0.3", "data.batch_size=64", "runtime.out_dir=/x/y"]
    want = jconfig._to_dict(jconfig.load_config([str(path)], overrides))
    got = config._to_dict(config.load_config([str(path)], overrides))
    assert got == want


def test_config_composition(tmp_path):
    base, override = tmp_path / "base.yaml", tmp_path / "override.yaml"
    yaml.safe_dump({"train": {"lr": 0.5, "epochs": 100}}, open(base, "w"))
    yaml.safe_dump({"train": {"lr": 0.25}}, open(override, "w"))
    cfg = config.load_config([str(base), str(override)], ["train.epochs=7",
                                                          "runtime.mesh_shape={\"data\": 1}"])
    assert cfg.train.lr == 0.25  # later file wins
    assert cfg.train.epochs == 7  # --set wins over both
    assert cfg.train.momentum == 0.9  # defaults kept
    assert cfg.runtime.mesh_shape == {"data": 1}
    path = config.save_config(cfg, str(tmp_path / "out"))
    assert os.path.basename(path) == "saved_config.yaml"
    reloaded = config.load_config([path])
    assert config._to_dict(reloaded) == config._to_dict(cfg)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX fit of the smoke config without draws: its initial variables,
    those after the first step and the final ones, and its records."""
    tmp = tmp_path_factory.mktemp("jax")
    cfg = _smoke(jconfig.Config(), tmp)
    cfg.train.mixup_alpha = cfg.train.cutmix_alpha = 0.0
    cfg.runtime.log_every = 1
    cfg.runtime.checkpoint_every_epochs = 2  # no orbax save (18 s here); records unchanged
    trainer = JaxTrainer(cfg)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    state_dict = lambda s: flax_to_state_dict(to_np(s.params), to_np(s.batch_stats))
    initial = state_dict(trainer.state)
    after = {}
    step = trainer.train_step

    def recording_step(*args):
        new_state, metrics = step(*args)
        if not after:
            after.update(state_dict(new_state))
        return new_state, metrics

    trainer.train_step = recording_step
    trainer.fit()
    return initial, after, state_dict(trainer.state), _records(cfg)


def _global_rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].double() - w.double()) ** 2).sum()) for k, w in want.items())
    den = sum(float((w.double() ** 2).sum()) for w in want.values())
    return (num / den) ** 0.5


def test_trainer_matches_jax(jax_run, tmp_path):
    initial, want_after, want_final, want_records = jax_run
    cfg = _smoke(config.Config(), tmp_path)
    cfg.train.mixup_alpha = cfg.train.cutmix_alpha = 0.0
    cfg.runtime.log_every = 1
    cfg.runtime.checkpoint_every_epochs = 2
    trainer = Trainer(cfg, device="cpu")
    trainer.state.model.load_state_dict(initial, strict=True)
    after = {}
    train_batch = trainer.train_batch

    def recording_batch(batch):
        metrics = train_batch(batch)
        if not after:
            after.update({k: v.clone() for k, v in trainer.state.model.state_dict().items()})
        return metrics

    trainer.train_batch = recording_batch
    trainer.fit()
    got_records = _records(cfg)
    assert len(got_records) == len(want_records) == 11
    for got, want in zip(got_records, want_records):
        assert got.keys() == want.keys(), (got, want)
        for key in ("train/loss", "val/loss"):
            if key in want:
                assert abs(got[key] - want[key]) <= REL * abs(want[key]), (key, got, want)
        if "lr" in want:
            assert abs(got["lr"] - want["lr"]) <= 1e-7, (got, want)
        for key in ("val/acc", "val/acc5", "epoch", "step"):
            if key in want:
                assert abs(got[key] - want[key]) <= 1e-6, (key, got, want)
    assert set(want_after) <= set(after)
    for name, want in want_after.items():
        assert _rel_l2(after[name].numpy(), want.numpy()) <= REL, name
    assert _global_rel_l2(trainer.state.model.state_dict(), want_final) <= 1e-3
    assert trainer.state.step == 10


def _state_arrays(trainer):
    arrays = {k: v.detach().clone() for k, v in trainer.state.model.state_dict().items()}
    for gi, group in enumerate(trainer.state.optimizer.buffers):
        for pi, t in enumerate(group):
            arrays[f"momentum.{gi}.{pi}"] = t.clone()
    return arrays


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_is_bit_equal(tmp_path):
    """2 epochs straight = 1 epoch + resume + 1 epoch, bit for bit, and the
    restored state equals the saved one; the resumed fit starts at epoch 1."""
    straight = Trainer(_cfg(tmp_path, "straight", epochs=2), device="cpu")
    straight.fit()

    first = Trainer(_cfg(tmp_path, "first", epochs=1), device="cpu")
    first.fit()
    saved = _state_arrays(first)
    ckpt = os.path.join(first.cfg.runtime.out_dir, "checkpoints", "step_3")
    cfg = _cfg(tmp_path, "first", epochs=2)
    cfg.runtime.resume = ckpt
    resumed = Trainer(cfg, device="cpu")
    assert resumed.state.step == 3
    _assert_bit_equal(_state_arrays(resumed), saved)
    resumed.fit()
    assert resumed.state.step == 6
    _assert_bit_equal(_state_arrays(resumed), _state_arrays(straight))
    epochs = [r["epoch"] for r in _records(cfg) if "epoch_time_s" in r]
    assert epochs == [0, 1]  # epoch 0 from the first run, then only epoch 1 appended


def test_fresh_start_truncates_metrics(tmp_path):
    """A second fresh fit into the same out_dir does not append to the first
    one's log (the JAX trainer appends, ADVICE.md:3); a resume does."""
    for _ in range(2):
        cfg = _cfg(tmp_path)
        Trainer(cfg, device="cpu").fit()
        assert [r.get("step") for r in _records(cfg) if "step" in r] == [1, 2, 3]
    cfg = _cfg(tmp_path, epochs=2)
    cfg.runtime.resume = os.path.join(cfg.runtime.out_dir, "checkpoints", "step_3")
    Trainer(cfg, device="cpu").fit()
    assert [r.get("step") for r in _records(cfg) if "step" in r] == [1, 2, 3, 4, 5, 6]


def test_best_follows_val_acc(tmp_path):
    cfg = _cfg(tmp_path, steps=1, epochs=3)
    trainer = Trainer(cfg, device="cpu")
    accs = iter([0.5, 0.3, 0.7])
    trainer.evaluate = lambda: {"val/acc": next(accs)}
    best_steps = []
    save = trainer.save

    def recording_save(epoch, val_acc=None):
        path = save(epoch, val_acc)
        meta = torch.load(os.path.join(cfg.runtime.out_dir, "best", "state.pt"),
                          weights_only=True)
        best_steps.append(meta["step"])
        return path

    trainer.save = recording_save
    trainer.fit()
    assert best_steps == [1, 1, 3]
    assert trainer.best_acc == 0.7


def test_echo_doubles_steps(tmp_path):
    cfg = _cfg(tmp_path, steps=2)
    cfg.data.echo = 2
    trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    assert trainer.state.step == 4  # 2 host batches × 2 echoes
    assert [r["step"] for r in _records(cfg) if "step" in r] == [2, 4]  # logged per host batch


def test_evaluate_ragged_final_batch(tmp_path):
    """A final val batch of 8 rows is padded to 16 with label -1 and counted
    exactly: the metrics equal those of aligned batches of 8."""
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.random((24, 32, 32, 3), np.float32)
    labels = rng.integers(0, 10, 24).astype(np.int32)
    trainer.val_loader = [(images[:16], labels[:16]), (images[16:], labels[16:])]
    got = trainer.evaluate()
    trainer.val_loader = [(images[i:i + 8], labels[i:i + 8]) for i in range(0, 24, 8)]
    cfg.data.batch_size = 8
    want = trainer.evaluate()
    for key in ("val/loss", "val/acc", "val/acc5"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6)


def test_val_cache_reused(tmp_path):
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, device="cpu")
    rng = np.random.default_rng(1)
    images = rng.random((32, 32, 32, 3), np.float32)
    labels = rng.integers(0, 10, 32).astype(np.int32)
    loader = [(images[:16], labels[:16]), (images[16:], labels[16:])]
    trainer.val_loader = loader
    first = trainer.evaluate()
    cached = trainer._val_cache
    assert cached[0] is loader and len(cached[1]) == 2
    loader[:] = []  # a second evaluate must read the cache, not the loader
    assert trainer.evaluate() == first
    other = [(images[:16], labels[:16])]
    trainer.val_loader = other
    trainer.evaluate()
    assert trainer._val_cache[0] is other  # a new loader object invalidates

    cfg.runtime.cache_val_limit_mb = 0  # a zero budget collects nothing
    t2 = Trainer(cfg, device="cpu")
    t2.val_loader = [(images[:16], labels[:16])]
    t2.evaluate()
    assert getattr(t2, "_val_cache", None) is None


def test_evaluate_without_val_data(tmp_path):
    trainer = Trainer(_cfg(tmp_path), device="cpu")
    trainer.val_loader = None
    assert trainer.evaluate() == {}


def test_sigterm_checkpoint(tmp_path):
    """SIGTERM during step 2 saves a resumable checkpoint at that step's
    boundary, and the handlers are restored afterwards."""
    cfg = _cfg(tmp_path, steps=6, epochs=50)
    trainer = Trainer(cfg, device="cpu")
    inner = trainer.train_batch

    def train_batch(batch):
        out = inner(batch)
        if trainer.state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    before = signal.getsignal(signal.SIGTERM)
    trainer.train_batch = train_batch
    state = trainer.fit()
    assert state.step == 2
    assert signal.getsignal(signal.SIGTERM) == before
    pre = [r for r in _records(cfg) if "preempted_at_step" in r]
    assert pre == [{"preempted_at_step": 2, "checkpoint": pre[0]["checkpoint"]}]
    cfg2 = _cfg(tmp_path, "resumed", steps=6)
    cfg2.runtime.resume = pre[0]["checkpoint"]
    assert Trainer(cfg2, device="cpu").state.step == 2


def test_resume_grad_accum_mismatch_is_loud(tmp_path):
    cfg = _cfg(tmp_path, steps=4, grad_accum_steps=2)
    trainer = Trainer(cfg, device="cpu")
    assert isinstance(trainer.state.optimizer, trainer_mod.MultiSteps)
    trainer.fit()
    assert (trainer.state.step, trainer.state.optimizer.count) == (4, 2)
    ckpt = os.path.join(cfg.runtime.out_dir, "checkpoints", "step_4")
    cfg2 = _cfg(tmp_path, "other", steps=4)
    cfg2.runtime.resume = ckpt
    with pytest.raises(ValueError, match="grad_accum_steps"):
        Trainer(cfg2, device="cpu")
    cfg3 = _cfg(tmp_path, "same", steps=4, grad_accum_steps=2)
    cfg3.runtime.resume = ckpt
    assert Trainer(cfg3, device="cpu").state.step == 4


def test_drop_overrides_reach_backbone(tmp_path):
    cfg = _cfg(tmp_path)
    cfg.model.backbone = "vit_ti_16"
    cfg.model.backbone_kwargs = {"img_size": 32}
    cfg.model.drop_out = 0.1
    cfg.model.drop_path = 0.05
    trainer = Trainer(cfg, device="cpu")
    assert trainer.backbone_overrides == {"dropout": 0.1, "stochastic_depth": 0.05}
    blocks = trainer.model.backbone.blocks
    assert {b.dropout for b in blocks} == {0.1}
    assert max(b.mha_droppath.p for b in blocks) == pytest.approx(0.05)


def _raw_dirs(tmp_path, n=48, store=24, classes=10):
    rng = np.random.default_rng(0)
    train, val = tmp_path / "train_raw", tmp_path / "val_raw"
    train.mkdir()
    val.mkdir()
    write_shard(str(train / "s0.vtraw"), rng.integers(0, 256, (n, store, store, 3), np.uint8),
                rng.integers(0, classes, n))
    write_shard(str(val / "s0.vtraw"), rng.integers(0, 256, (20, 16, 16, 3), np.uint8),
                rng.integers(0, classes, 20))
    return str(train), str(val)


def test_device_resident_fit_on_raw_shards(tmp_path):
    """The uint8 store goes to the device once, a step gets its (B,) index
    vector alone, and the fit runs the full recipe (TrivialAugment, erasing,
    CutMix⊕MixUp) on the device-side crops."""
    cfg = _cfg(tmp_path)
    cfg.data.synthetic = False
    cfg.data.train_dir, cfg.data.val_dir = _raw_dirs(tmp_path)
    cfg.data.raw_shards = cfg.data.device_resident = True
    cfg.data.train_crop_size, cfg.data.val_crop_size = 16, 16
    cfg.data.trivial_augment, cfg.data.random_erasing_p = True, 0.5
    trainer = Trainer(cfg, device="cpu")
    assert trainer._device_store[0].shape == (48, 24, 24, 3)
    trainer.fit()
    assert trainer.state.step == 3  # 48 images / batch 16
    assert trainer.feed.batches == 3
    records = _records(cfg)
    assert all(np.isfinite(r["train/loss"]) for r in records if "train/loss" in r)
    assert "val/acc" in records[-1]


def test_device_resident_requires_raw_shards(tmp_path):
    cfg = _cfg(tmp_path)
    cfg.data.synthetic = False
    cfg.data.train_dir = str(tmp_path)
    cfg.data.device_resident = True
    with pytest.raises(ValueError, match="raw_shards"):
        Trainer(cfg, device="cpu")


def test_cli_fit_and_validate(tmp_path, capsys):
    cfg_path = tmp_path / "cfg.yaml"
    yaml.safe_dump(config._to_dict(_cfg(tmp_path, "cli")), open(cfg_path, "w"))
    cli_main(["fit", "--config", str(cfg_path), "--set", "runtime.log_every=3",
              "--device", "cpu"])
    out_dir = tmp_path / "cli"
    records = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    assert (out_dir / "checkpoints" / "step_3").is_dir() and (out_dir / "best").is_dir()
    capsys.readouterr()
    cli_main(["validate", "--config", str(cfg_path), "--device", "cpu",
              "--set", f"runtime.resume={out_dir / 'checkpoints' / 'step_3'}"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("val/loss", "val/acc", "val/acc5"):
        assert got[key] == pytest.approx(records[-1][key], rel=1e-6, abs=1e-6)
    assert [json.loads(line) for line in open(out_dir / "metrics.jsonl")] == records


@pytest.mark.parametrize("setting", ["tp", "fsdp", "pipe", "model", "world"])
def test_parallel_configs_raise(tmp_path, monkeypatch, setting):
    cfg = _cfg(tmp_path)
    if setting in ("tp", "fsdp"):
        cfg.runtime.param_sharding = setting
    elif setting == "world":
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    else:
        cfg.runtime.mesh_shape = {"data": 1, setting: 2}
    with pytest.raises(NotImplementedError, match="item 12"):
        Trainer(cfg, device="cpu")


def test_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_cfg(tmp_path))


def test_trackers(tmp_path, monkeypatch):
    from vision_toolbox_tpu_torch.train import tracking

    assert isinstance(tracking.make_tracker("none", str(tmp_path)), tracking.NoopTracker)
    assert isinstance(tracking.make_tracker(None, str(tmp_path)), tracking.NoopTracker)
    for kind, module in (("tensorboard", "tensorboardX"), ("wandb", "wandb")):
        monkeypatch.setitem(sys.modules, module, None)  # not installed
        with pytest.raises(RuntimeError, match=module):
            tracking.make_tracker(kind, str(tmp_path))
    with pytest.raises(ValueError, match="none|tensorboard|wandb"):
        tracking.make_tracker("mlflow", str(tmp_path))


def test_backbone_export(tmp_path):
    """The backbone's state dict without its prefix, saved as
    ``{name}-{sha256[:8]}.pth`` (the reference's release naming) and loaded
    into a fresh backbone."""
    import hashlib

    from vision_toolbox_tpu_torch import create_backbone
    from vision_toolbox_tpu_torch.utils import checkpoint

    trainer = Trainer(_cfg(tmp_path), device="cpu")
    sd = checkpoint.extract_backbone(trainer.model)
    assert sd.keys() == trainer.model.backbone.state_dict().keys()
    name = trainer.cfg.model.backbone
    path = checkpoint.save_params_pth(sd, name, str(tmp_path))
    data = open(path, "rb").read()
    assert os.path.basename(path) == f"{name}-{hashlib.sha256(data).hexdigest()[:8]}.pth"
    loaded = checkpoint.load_params_pth(path)
    fresh = create_backbone(name, device="cpu")
    fresh.load_state_dict(loaded, strict=True)
    for k, v in sd.items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_profile_steps_trace(tmp_path):
    """runtime.profile_steps=2: a torch.profiler trace of steps 2 and 3,
    written and logged, and closed."""
    cfg = _cfg(tmp_path, steps=5)
    cfg.runtime.profile_steps = 2
    trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    trace = tmp_path / "run" / "profile" / "trace.json"
    assert trace.is_file() and json.loads(trace.read_text())["traceEvents"]
    logged = [r["profile_trace"] for r in _records(cfg) if "profile_trace" in r]
    assert logged == [str(trace)] and trainer._profiler is None
