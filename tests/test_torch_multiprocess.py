"""The port's parallel axes on two gloo ranks (vision_toolbox_tpu_torch/
parallel/, train/step.shard_train_step, the trainer's mesh).

One cluster of 2 processes (tests/torch_mp_worker.py) is launched for the
whole file by a module-scoped fixture, as tests/test_multiprocess.py
launches the JAX package's; every leg runs in that one launch and writes
records that the tests read. While the ranks run, this process runs the
JAX package's ``shard_train_step`` on a 2-device CPU mesh and the port's
world-1 trainer runs that the world-2 ones are held against.

Tolerances: JAX's own sync-BN test's (tests/test_train_step.py:267), rtol
2e-4 and atol 1e-5 on parameters, buffers and optimizer state; losses rel
≤ 1e-5. The two ranks' replicated parameters are bit-equal to each other.

- DP with BN: a narrow CSP Darknet, global batch 16, TrivialAugment,
  RandomErasing 0.5 and CutMix⊕MixUp, 3 steps on {"data": 2} against the
  port's one-process step on the global batch (draws from the same
  generators), and one step on JAX's initial variables and draws against
  JAX's ``shard_train_step`` on a 2-device mesh: the mix's roll crosses the
  shard boundary.
- BatchNorm and LinenBatchNorm on a rank's rows: running statistics and dx
  equal the global batch's.
- TP on {"data": 1, "model": 2} (SGD), FSDP on {"data": 2} (AdamW and
  LAMB) and replicated on {"data": 2} (AdamW): a narrow ViT whose blocks
  run the K3/K4 twins, projections sharded, 2 steps against the replicated
  run (the second step over a data axis of 2 at the twins' bf16 bounds: see
  the test); each rank holds only its shard of the sharded weights and of
  their optimizer state; each gradient is all-reduced once a step.
- The trainer at world 2, tp and fsdp: one epoch of a smoke config (two
  steps of mobilenet_v3_small at bs16@32), then a resume for a second; metrics.jsonl equals the world-1 run's, rank 0 alone
  writes, and the checkpoint restores into a replicated world-1 trainer
  with the same eval; a SIGTERM on one rank stops every rank at one step.
- The refusals at world 2 and the loaders' shards per data coordinate:
  raw shards, WebDataset, and the image-folder loaders, whose ranks'
  batches make up the one-process batches, alone and in a trainer.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import io
import json
import os
import socket
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image
from torch_draws import step_draws
from torch_mp_worker import image_folder_cfg, seed_pixel

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.warp as jwarp
from vision_toolbox_tpu.models.darknet import Darknet as JaxDarknet
from vision_toolbox_tpu.ops.warp_pallas import shear3_warp_pallas
from vision_toolbox_tpu.parallel import create_mesh as jax_mesh
from vision_toolbox_tpu.parallel import shard_batch
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu.train import shard_train_step as jax_shard_train_step
from vision_toolbox_tpu.train import warmup_cosine_schedule as jax_schedule
from vision_toolbox_tpu_torch.data import DataLoader, ImageFolder
from vision_toolbox_tpu_torch.data.native import NativeJPEGLoader, native_available
from vision_toolbox_tpu_torch.data.raw_shards import write_shard
from vision_toolbox_tpu_torch.train import config
from vision_toolbox_tpu_torch.train.trainer import Trainer
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

NPROC = 2
HERE = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL, LOSS_REL = 2e-4, 1e-5, 1e-5
CLASSES, SEED = 10, 7
# the workers' narrow Darknet, recipe and schedule (tests/torch_mp_worker.py)
DARKNET = dict(stem_channels=8, stage_configs=((1, 16), (1, 32)), csp=True)
SCHEDULE = dict(base_lr=0.5, total_epochs=100, steps_per_epoch=1, warmup_epochs=1)
TRAINER_CFG = {"model.backbone": "mobilenet_v3_small", "model.num_classes": CLASSES,
               "model.bf16": False, "data.synthetic": True, "data.batch_size": 16,
               "data.train_size": 32, "data.train_crop_size": 32, "data.val_crop_size": 32,
               "data.trivial_augment": False, "data.random_erasing_p": 0.0,
               "train.warmup_epochs": 1, "runtime.log_every": 1,
               "runtime.sharding_min_size": 4096}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _trainer_cfg(out_dir: str, epochs: int, resume: str | None = None) -> config.Config:
    cfg = config.Config()
    for k, v in TRAINER_CFG.items():
        section, key = k.split(".")
        setattr(getattr(cfg, section), key, v)
    cfg.train.epochs, cfg.runtime.out_dir, cfg.runtime.resume = epochs, out_dir, resume
    return cfg


def _records(out_dir: str) -> list[dict]:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jax_step(variables, images, labels):
    """One step of JAX's ``shard_train_step`` on a 2-device mesh; its
    TrivialAugment warp on the shear3 kernel (interpret mode), as the port's."""
    jm = JaxClassifier(backbone=JaxDarknet(**DARKNET), num_classes=CLASSES)
    tx = jax_sgd(variables["params"], jax_schedule(**SCHEDULE), momentum=0.9, weight_decay=2e-5)
    state = JaxState.create(jm.apply, variables, tx)
    step = jax_train_step(CLASSES, label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0,
                          trivial_augment=True, random_erasing_p=0.5)
    mesh = jax_mesh(("data",), (2,), devices=jax.devices()[:2])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "affine_warp",
                   lambda im, op, mag: shear3_warp_pallas(im, op, mag, interpret=True))
        state, metrics = jax_shard_train_step(step, mesh)(
            state, *shard_batch((jnp.asarray(images), jnp.asarray(labels)), mesh),
            jax.random.PRNGKey(SEED))
    sd = flax_to_state_dict(_np(state.params), _np(state.batch_stats))
    return float(metrics["loss"]), {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mp")
    in_dir, out_dir = tmp / "in", tmp / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (16, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, CLASSES, 16).astype(np.int32)
    jm = JaxClassifier(backbone=JaxDarknet(**DARKNET), num_classes=CLASSES)
    variables = _np(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))())
    draws = step_draws(jax.random.PRNGKey(SEED), 0, images.shape, trivial_augment=True,
                       random_erasing_p=0.5, mixup_alpha=0.2, cutmix_alpha=1.0)
    raw_dir = tmp / "raw"
    raw_dir.mkdir()
    for i, n in enumerate((9, 14)):  # 23 images over 2 shards: 11 + 12 per data rank
        write_shard(str(raw_dir / f"s{i}.vtraw"), rng.integers(0, 256, (n, 16, 16, 3), np.uint8),
                    np.arange(sum((9, 14)[:i]), sum((9, 14)[:i]) + n, dtype=np.int32))
    wds_shards = []
    for i in range(4):  # 16 samples, 4 a tar shard, labelled by their index
        wds_shards.append(str(tmp / f"{i:04d}.tar"))
        with tarfile.open(wds_shards[-1], "w") as tf:
            for idx in range(4 * i, 4 * i + 4):
                buf = io.BytesIO()
                Image.new("RGB", (8, 8), (idx * 15, 0, 0)).save(buf, format="JPEG")
                for ext, data in (("jpg", buf.getvalue()), ("cls", str(idx).encode())):
                    info = tarfile.TarInfo(f"{idx:06d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    image_folder = tmp / "folder"
    for idx in range(23):  # one JPEG a class: a sample's label is its index
        (image_folder / f"c{idx:02d}").mkdir(parents=True)
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8)).save(
            image_folder / f"c{idx:02d}" / "0.jpg")
    torch.save(dict(images=images, labels=labels, jax_draws=draws, raw_dir=str(raw_dir),
                    wds_shards=wds_shards, image_folder=str(image_folder),
                    init=flax_to_state_dict(variables["params"], variables["batch_stats"]),
                    trainer_cfg=TRAINER_CFG), in_dir / "inputs.pt")

    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(NPROC)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mp_worker.py"),
                               str(r), str(NPROC), port, str(in_dir), str(out_dir)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(NPROC)]
    try:
        # meanwhile: JAX's sharded step, and the world-1 trainer runs
        jax_loss, jax_state = _jax_step(variables, images, labels)
        world1 = str(tmp / "world1")
        Trainer(_trainer_cfg(world1, 1), device="cpu").fit()
        Trainer(_trainer_cfg(world1, 2, os.path.join(world1, "checkpoints", "step_2")),
                device="cpu").fit()
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (out_dir / f"rank{r}.log").read_text()[-4000:]
    records = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(NPROC)]
    return dict(records=records, jax_loss=jax_loss, jax_state=jax_state, world1=world1,
                out_dir=str(out_dir), image_folder=str(image_folder))


def _close(got: dict, want: dict, what: str, keys=None):
    keys = sorted(want) if keys is None else keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


def _losses_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_REL * abs(w), (got, want)


def test_cluster_is_two_gloo_ranks(cluster):
    assert [r["rank"] for r in cluster["records"]] == [0, 1]
    assert all(r["world"] == NPROC for r in cluster["records"])


def test_dp_full_recipe_equals_one_process(cluster):
    """3 full-recipe steps on {"data": 2}: losses, parameters, BN running
    statistics and momentum equal the one-process step on the global
    batch."""
    r0, r1 = cluster["records"]
    for rec in (r0, r1):
        _losses_close(rec["dp/losses"], r0["dp/oracle_losses"])
        _close(rec["dp/state"], r0["dp/oracle_state"], "dp")


def test_dp_replicas_are_bit_equal(cluster):
    r0, r1 = cluster["records"]
    assert r0["dp/state"].keys() == r1["dp/state"].keys()
    for k, v in r0["dp/state"].items():
        assert np.array_equal(v, r1["dp/state"][k]), k
    assert r0["dp/losses"] == r1["dp/losses"]


def test_dp_step_matches_jax_shard_train_step(cluster):
    """One step from JAX's initial variables with JAX's draws on each side:
    the port on 2 gloo ranks against JAX's ``shard_train_step`` on a
    2-device mesh (the mix pairs rank 1's first row with rank 0's last)."""
    want = cluster["jax_state"]
    for rec in cluster["records"]:
        assert abs(rec["jax/loss"] - cluster["jax_loss"]) <= LOSS_REL * abs(cluster["jax_loss"])
        got = {k.split("/", 1)[1]: v for k, v in rec["jax/state"].items()
               if k.startswith(("param/", "buffer/"))}
        assert got.keys() == want.keys()
        _close(got, want, "port dp vs jax")


@pytest.mark.parametrize("module", ["BatchNorm", "LinenBatchNorm"])
def test_bn_statistics_are_the_global_batch_ones(cluster, module):
    """Running mean and variance after one train-mode pass on a rank's rows
    (``BatchNorm``'s unbiased with the global n, ``LinenBatchNorm``'s
    biased) equal the global batch's, and so does each rank's dx."""
    for rec in cluster["records"]:
        for what, (got, want) in rec[f"bn/{module}"].items():
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _slice_like(whole: np.ndarray, shard: np.ndarray, rank: int) -> np.ndarray:
    """Rank ``rank``'s slice of ``whole`` along the dim ``shard`` is cut on."""
    if shard.shape == whole.shape:
        return whole
    dim = next(d for d in range(shard.ndim) if shard.shape[d] != whole.shape[d])
    n = shard.shape[dim]
    return np.take(whole, range(rank * n, (rank + 1) * n), axis=dim)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("leg", ["tp", "fsdp_adamw", "fsdp_lamb", "dp_adamw"])
def test_sharded_steps_equal_replicated(cluster, leg):
    """The narrow ViT, projections and MLP sharded (or, ``dp_adamw``, all
    replicated over {"data": 2}), against the replicated one-process run:
    after step 1 each rank's losses, shards, replicated parameters and
    optimizer state at rtol 2e-4 / atol 1e-5 (TP: after both steps). A
    second step over a data axis of 2 starts from parameters that differ
    from the one-process ones by f32 summation noise, and the K3/K4 twins
    round the weights to bf16 at use, so a weight within that noise of a
    bf16 rounding boundary rounds the other way: after step 2 it is held to
    the twins' own bounds against JAX (tests/test_torch_vit_train.py: loss
    rel 1e-3, rel L2 ≤ 1e-2 per tensor), the key-projection biases apart:
    their gradient is zero in exact arithmetic (tests/test_torch_vit_train.py),
    and AdamW's and LAMB's normalized step turns each run's summation noise
    there into an update of the learning rate's size."""
    records = cluster["records"]
    of = "fsdp_adamw" if leg == "dp_adamw" else leg  # the replicated leg's oracle
    oracle = next(r for r in records if f"{of}/oracle_states" in r)
    exact_steps = 2 if leg == "tp" else 1
    for rank, rec in enumerate(records):
        got_losses, want_losses = rec[f"{leg}/losses"], oracle[f"{of}/oracle_losses"]
        _losses_close(got_losses[:exact_steps], want_losses[:exact_steps])
        for step in range(exact_steps):
            got, want = rec[f"{leg}/states"][step], oracle[f"{of}/oracle_states"][step]
            assert got.keys() == want.keys()
            for k, v in got.items():
                np.testing.assert_allclose(v, _slice_like(want[k], v, rank), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{leg} step {step + 1} {k}")
        if exact_steps == 2:
            continue
        assert abs(got_losses[1] - want_losses[1]) <= 1e-3 * abs(want_losses[1])
        got, want = rec[f"{leg}/states"][1], oracle[f"{of}/oracle_states"][1]
        for k, v in got.items():
            if not k.endswith("k_proj.bias"):
                assert _rel_l2(v, _slice_like(want[k], v, rank)) <= 1e-2, (leg, k)


@pytest.mark.parametrize("leg", ["tp", "fsdp_adamw", "fsdp_lamb"])
def test_ranks_hold_only_their_shards(cluster, leg):
    """The projections and MLP weights are halved along the rule's dim
    (dim 0 of the port's (out, in) weights under TP, the largest dim under
    FSDP), and so is their optimizer state; the rest stays whole."""
    for rec in cluster["records"]:
        whole, state = rec[f"{leg}/whole_shapes"], rec[f"{leg}/states"][-1]
        halved = {k.split("/", 1)[1] for k, v in state.items() if k.startswith("param/")
                  and v.shape != whole[k.split("/", 1)[1]]}
        assert {k for k in halved if "blocks" in k} == {
            f"backbone.blocks.{i}.{m}.weight" for i in range(2)
            for m in ("mha.q_proj", "mha.k_proj", "mha.v_proj", "mha.out_proj",
                      "mlp.linear1", "mlp.linear2")}
        for k in halved:
            shape = state[f"param/{k}"].shape
            if leg == "tp":
                assert shape == (whole[k][0] // 2, whole[k][1]), k
            for name in ("buffers", "mu", "nu"):
                if f"{name}/{k}" in state:
                    assert state[f"{name}/{k}"].shape == shape, (name, k)
        optimizer = [k for k in state if k.startswith(("buffers/", "mu/"))]
        assert optimizer, "no optimizer state recorded"


def _comparable(record: dict) -> dict:
    return {k: v for k, v in record.items() if "time" not in k and "ips" not in k}


@pytest.mark.parametrize("leg", ["tp", "fsdp"])
def test_trainer_world2_matches_world1(cluster, leg):
    """One epoch, then a resume for a second: metrics.jsonl of the world-2
    run (written by rank 0) equals the world-1 run's."""
    got = [_comparable(r) for r in _records(cluster["records"][0][f"trainer/{leg}/dir"])]
    want = [_comparable(r) for r in _records(cluster["world1"])]
    assert [r.keys() for r in got] == [r.keys() for r in want]
    assert len([r for r in got if "val/loss" in r]) == 2
    for g, w in zip(got, want):
        for k, v in w.items():
            if k in ("train/loss", "val/loss"):
                assert abs(g[k] - v) <= LOSS_REL * abs(v), (leg, g, w)
            else:
                assert g[k] == pytest.approx(v, rel=RTOL, abs=ATOL), (leg, k, g, w)
    assert cluster["records"][0][f"trainer/{leg}/sharded"], "no parameter was sharded"


@pytest.mark.parametrize("leg", ["tp", "fsdp"])
def test_trainer_rank0_alone_writes(cluster, leg):
    rank0, rank1 = (r[f"trainer/{leg}/dir"] for r in cluster["records"])
    assert sorted(os.listdir(rank0)) == ["best", "checkpoints", "metrics.jsonl",
                                         "saved_config.yaml"]
    assert sorted(os.listdir(os.path.join(rank0, "checkpoints"))) == ["step_2", "step_4"]
    assert not os.path.exists(rank1)


@pytest.mark.parametrize("leg", ["tp", "fsdp"])
def test_checkpoint_restores_into_world1(cluster, leg, tmp_path):
    """The world-2 checkpoint after epoch 0 holds whole tensors: a
    replicated world-1 trainer restores it and evaluates what the world-2
    run logged for that epoch."""
    run = cluster["records"][0][f"trainer/{leg}/dir"]
    ckpt = os.path.join(run, "checkpoints", "step_2")
    trainer = Trainer(_trainer_cfg(str(tmp_path / "restored"), 1, ckpt), device="cpu")
    assert trainer.state.step == 2
    got = trainer.evaluate()
    want = next(r for r in _records(run) if "val/loss" in r)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=RTOL, abs=ATOL), (k, got, want)


def test_sigterm_on_one_rank_stops_every_rank(cluster):
    """Rank 1 alone is signalled, after its first step: the flag is
    all-reduced, both ranks stop at step 1, and rank 0 writes the
    preemption checkpoint and its record."""
    rank0, rank1 = (r["trainer/preempted"] for r in cluster["records"])
    assert rank0["step"] == rank1["step"] == 1
    assert _records(rank0["dir"])[-1]["preempted_at_step"] == 1
    assert os.listdir(os.path.join(rank0["dir"], "checkpoints")) == ["step_1"]
    assert not os.path.exists(rank1["dir"])


def test_refusals_at_world_2(cluster):
    for rec in cluster["records"]:
        out = rec["refusals"]
        assert out["mesh_product"][0] == "ValueError" and "world has 2" in out["mesh_product"][1]
        assert out["batch_remainder"][0] == "ValueError"
        assert out["trainer_batch"][0] == "ValueError" and "divisible" in out["trainer_batch"][1]
        assert out["device_resident"][0] == "NotImplementedError"
        assert "single-process" in out["device_resident"][1]


def test_loader_shards_follow_the_data_coordinate(cluster):
    """{"data": 2}: the two ranks' rows are disjoint and complete, and so
    are their shard lists, and the WebDataset loader reads each sample
    exactly once over the two ranks (tests/test_multiprocess.py:91 and :100
    for the JAX package's); the image-folder ``DataLoader``'s two ranks'
    batches of each step make up the one-process loader's batch of that
    step at the global batch, samples and seeds alike, for train (shuffled,
    ragged end dropped) and val (every sample once); {"data": 1, "model":
    2}: both ranks read every row, and the image-folder batches are the
    one-process loader's."""
    data2 = [r["data/data2"] for r in cluster["records"]]
    assert [d["shard"] for d in data2] == [(0, 2), (1, 2)]
    labels = [d["labels"] for d in data2]
    assert not set(labels[0]) & set(labels[1])
    assert sorted(labels[0] + labels[1]) == list(range(23))
    shards = [d["shards"] for d in data2]
    assert not set(shards[0]) & set(shards[1]) and len(shards[0] + shards[1]) == 7
    wds = [d["wds_labels"] for d in data2]
    assert sorted(wds[0] + wds[1]) == list(range(16)) and wds[0] and wds[1]
    model2 = [r["data/model2"] for r in cluster["records"]]
    assert sorted(model2[0]["wds_labels"]) == sorted(model2[1]["wds_labels"]) == list(range(16))
    assert [d["shard"] for d in model2] == [(0, 1), (0, 1)]
    assert model2[0]["labels"] == model2[1]["labels"] == list(range(23))
    assert model2[0]["shards"] == model2[1]["shards"] and len(model2[0]["shards"]) == 7

    folder = ImageFolder(cluster["image_folder"])
    for split, kw in (("folder_train", dict(shuffle=True, drop_last=True, seed=3)),
                      ("folder_val", {})):
        for recs, batch in ((data2, 8), (model2, 4)):
            want = DataLoader(folder, batch, seed_pixel, num_workers=2, process_index=0,
                              process_count=1, **kw)
            want = [(np.asarray(im), np.asarray(lab)) for im, lab in want]
            ranks = [r[split] for r in recs]
            if batch == 4:  # the model axis: every rank reads the one-process batches
                assert [n for n, _ in ranks] == [len(want)] * 2
                for _, got in ranks:
                    for (gi, gl), (wi, wl) in zip(got, want, strict=True):
                        assert np.array_equal(gi, wi) and np.array_equal(gl, wl), split
                continue
            assert [n for n, _ in ranks] == [len(got) for _, got in ranks]
            assert max(n for n, _ in ranks) == len(want), split
            for b, (wi, wl) in enumerate(want):
                parts = [got[b] for _, got in ranks if b < len(got)]
                assert np.array_equal(np.concatenate([p[0] for p in parts]), wi), (split, b)
                assert np.array_equal(np.concatenate([p[1] for p in parts]), wl), (split, b)
            seen = np.concatenate([lab for _, got in ranks for _, lab in got]).tolist()
            assert len(seen) == len(set(seen))
            assert len(seen) == (16 if split == "folder_train" else 23)


def test_native_loader_shards_follow_the_data_coordinate(cluster):
    """``NativeJPEGLoader`` on {"data": 2}: each step's two batches hold
    disjoint samples that make up the one-process loader's batch of that
    step (their crops are each rank's own draws); on {"data": 1, "model":
    2}: both ranks yield the one-process loader's batches."""
    if not native_available():
        pytest.skip("native/libvttdata.so cannot be built here (libjpeg missing)")
    folder = ImageFolder(cluster["image_folder"])
    for leg, batch in (("data2", 8), ("model2", 4)):
        want = [(np.asarray(im), np.asarray(lab)) for im, lab in
                NativeJPEGLoader(folder, batch, 16, num_threads=2, seed=3, process_index=0,
                                 process_count=1)]
        ranks = [r[f"data/{leg}"]["native"] for r in cluster["records"]]
        assert [n for n, _ in ranks] == [len(want)] * 2 == [len(got) for _, got in ranks]
        for b, (wi, wl) in enumerate(want):
            got = [g[b] for _, g in ranks]
            if leg == "model2":
                for gi, gl in got:
                    assert np.array_equal(gi, wi) and np.array_equal(gl, wl), (leg, b)
            else:
                assert not set(got[0][1].tolist()) & set(got[1][1].tolist()), b
                assert sorted(np.concatenate([g[1] for g in got]).tolist()) == sorted(wl.tolist())


def test_image_folder_trainer_splits_its_loaders(cluster, tmp_path):
    """The trainer at {"data": 2} on an image folder gives each loader its
    rank's data-axis coordinate: the epoch has the world-1 trainer's steps
    (23 images // global batch 4), the two ranks' val rows make up the val
    set once, and the eval equals the world-1 trainer's."""
    ranks = [r["folder_trainer"] for r in cluster["records"]]
    world1 = Trainer(image_folder_cfg(cluster["image_folder"], str(tmp_path / "world1")),
                     device="cpu")
    assert world1.steps_per_epoch == 5
    assert [r["steps_per_epoch"] for r in ranks] == [5, 5]
    assert [r["shares"] for r in ranks] == [[(0, 2)] * 2, [(1, 2)] * 2]
    assert sum(r["val_rows"] for r in ranks) == 23
    want = world1.evaluate()
    for r in ranks:
        assert r["eval"].keys() == want.keys()
        for k, v in want.items():
            assert r["eval"][k] == pytest.approx(v, rel=RTOL, abs=ATOL), (k, r["eval"], want)


@pytest.mark.parametrize("leg", ["dp_adamw", "fsdp_adamw"])
def test_each_gradient_is_reduced_once(cluster, leg):
    """The elements all-reduced in a step over {"data": 2}: every
    parameter's whole gradient once (the K3/K4 weight gradients where they
    are made, the rest in the gathers' backward or the flat all-reduce)
    and the loss; AdamW itself reduces nothing."""
    for rec in cluster["records"]:
        whole = sum(int(np.prod(s)) for s in rec[f"{leg}/whole_shapes"].values())
        assert rec[f"{leg}/all_reduced"] == [whole + 1] * 2, (whole, rec[f"{leg}/all_reduced"])
