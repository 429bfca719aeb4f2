"""One rank of the port's multi-rank test cluster (tests/test_torch_multiprocess.py).

    python tests/torch_mp_worker.py <rank> <world> <port> <in_dir> <out_dir>

Joins a gloo world through ``parallel/mesh.init_process_group`` (env://),
then runs every leg of the test in one launch, each on a mesh of its own,
and writes its records to ``<out_dir>/rank<rank>.pt``. The single-process
oracles run on one rank each (a plain step here involves no collective).
Imports torch and the port only: the JAX package's initial variables and
draws come from ``<in_dir>`` as torch files.
"""

from __future__ import annotations

import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_threads  # noqa: E402,F401  (one torch CPU thread per test process)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from vision_toolbox_tpu_torch.data import DataLoader, ImageFolder, datasets  # noqa: E402
from vision_toolbox_tpu_torch.data.native import NativeJPEGLoader, native_available  # noqa: E402
from vision_toolbox_tpu_torch.data.raw_shards import RawShardDataset, RawShardLoader  # noqa: E402
from vision_toolbox_tpu_torch.data.wds_loader import WebDatasetLoader  # noqa: E402
from vision_toolbox_tpu_torch.models.darknet import Darknet  # noqa: E402
from vision_toolbox_tpu_torch.models.vit import ViT  # noqa: E402
from vision_toolbox_tpu_torch.nn.norm import BatchNorm, LinenBatchNorm  # noqa: E402
from vision_toolbox_tpu_torch.parallel import (  # noqa: E402
    batch_rows,
    create_mesh,
    data_parallel,
    init_process_group,
    shard_train_state,
)
from vision_toolbox_tpu_torch.train import (  # noqa: E402
    ImageClassifier,
    TrainState,
    config,
    make_optimizer,
    make_train_step,
    shard_train_step,
    warmup_cosine_schedule,
)
from vision_toolbox_tpu_torch.train.trainer import Trainer  # noqa: E402

DARKNET = dict(stem_channels=8, stage_configs=((1, 16), (1, 32)), csp=True)
VIT = dict(d_model=128, depth=2, n_heads=4, patch_size=8, img_size=32)
CLASSES = 10
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0, trivial_augment=True,
              random_erasing_p=0.5)
VIT_RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
SCHEDULE = dict(base_lr=0.5, total_epochs=100, steps_per_epoch=1, warmup_epochs=1)
MIN_SIZE = 4096  # the narrow ViT's projections (128 × 128) and MLP (128 × 512) shard


def seed_pixel(r, image):
    """The image-folder loaders' transform in the data legs: one value drawn
    from the sample's generator, so that a batch shows the seeds it was
    given (tests/test_torch_multiprocess.py makes the same)."""
    return np.full((1,), r.random(), np.float32)


def _snapshot(state: TrainState) -> dict:
    """Parameters, buffers and optimizer state as numpy (the local shards)."""
    out = {f"param/{n}": p.detach().numpy().copy() for n, p in state.model.named_parameters()}
    out |= {f"buffer/{n}": b.numpy().copy() for n, b in state.model.named_buffers()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    opt = state.optimizer
    for name in opt.STATE:
        for lst, (_, ps) in zip(getattr(opt, name) or [], opt.groups):
            for p, t in zip(ps, lst or []):
                if t is not None:
                    out[f"{name}/{names[id(p)]}"] = t.numpy().copy()
    return out


def _darknet_state(init: dict) -> TrainState:
    model = ImageClassifier(Darknet(**DARKNET, device="cpu"), CLASSES)
    model.load_state_dict(init, strict=True)
    opt = make_optimizer("sgd", model, warmup_cosine_schedule(**SCHEDULE), momentum=0.9,
                         weight_decay=2e-5)
    return TrainState(model, opt)


def _vit_state(optimizer: str) -> TrainState:
    gen = torch.Generator().manual_seed(0)
    model = ImageClassifier(ViT(**VIT, device="cpu", generator=gen), CLASSES, generator=gen)
    lr = 1e-3 if optimizer in ("adamw", "lamb") else 0.1
    return TrainState(model, make_optimizer(optimizer, model, lr, momentum=0.9,
                                            weight_decay=2e-5))


def _steps(step, state, images, labels, n, seed=0, draws=None) -> list[float]:
    losses = []
    for i in range(n):
        g = torch.Generator().manual_seed(seed + i)
        losses.append(float(step(state, images, labels, g, draws)["loss"]))
    return losses


def dp_legs(rank: int, inp: dict, rec: dict) -> None:
    """The full recipe on a narrow Darknet with BatchNorm, global batch 16,
    {"data": 2}: 3 steps on the port's own draws and one on JAX's."""
    mesh = create_mesh(("data",), (2,))
    rows = batch_rows(mesh, 16)
    images, labels = torch.from_numpy(inp["images"]), torch.from_numpy(inp["labels"])
    step = make_train_step(CLASSES, **RECIPE)
    sharded = shard_train_step(step, mesh)

    state = _darknet_state(inp["init"])
    rec["dp/losses"] = _steps(sharded, state, images[rows], labels[rows], 3)
    rec["dp/state"] = _snapshot(state)
    if rank == 0:  # the one-process oracle on the global batch
        state = _darknet_state(inp["init"])
        rec["dp/oracle_losses"] = _steps(step, state, images, labels, 3)
        rec["dp/oracle_state"] = _snapshot(state)

    state = _darknet_state(inp["init"])
    rec["jax/loss"] = _steps(sharded, state, images[rows], labels[rows], 1,
                             draws=inp["jax_draws"])[0]
    rec["jax/state"] = _snapshot(state)


def bn_leg(rank: int, rec: dict) -> None:
    """BatchNorm and LinenBatchNorm in train mode on this rank's rows inside
    the data axis: running statistics and dx against the global batch."""
    mesh = create_mesh(("data",), (2,))
    rows = batch_rows(mesh, 16)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(16, 4, 4, 8, generator=g) * 2 + 0.5
    w = torch.randn(16, 4, 4, 8, generator=g)
    for cls in (BatchNorm, LinenBatchNorm):
        name = cls.__name__
        local, oracle = cls(8), cls(8)
        xl = x[rows].clone().requires_grad_()
        with data_parallel(mesh):
            (local(xl, train=True) * w[rows]).sum().backward()
        xg = x.clone().requires_grad_()
        (oracle(xg, train=True) * w).sum().backward()
        rec[f"bn/{name}"] = dict(
            running_mean=(local.running_mean.numpy(), oracle.running_mean.numpy()),
            running_var=(local.running_var.numpy(), oracle.running_var.numpy()),
            dx=(xl.grad.numpy(), xg.grad[rows].numpy()))


def vit_legs(rank: int, rec: dict) -> None:
    """TP on {"data": 1, "model": 2} (SGD), FSDP on {"data": 2} (AdamW,
    LAMB) and replicated on {"data": 2} (AdamW): a narrow ViT whose blocks
    run the K3/K4 twins, 2 steps each (the state recorded after each, and
    the elements all-reduced in each sharded step), against the replicated
    one-process run on the global batch of 8 (the replicated leg against
    FSDP AdamW's)."""
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3)).astype(np.uint8))
    labels = torch.from_numpy(rng.integers(0, CLASSES, 8).astype(np.int64))
    step = make_train_step(CLASSES, **VIT_RECIPE)

    reduced = []
    all_reduce = dist.all_reduce

    def counting_all_reduce(t, *args, **kwargs):
        reduced.append(t.numel())
        return all_reduce(t, *args, **kwargs)

    def run(train_step, state, rows, counts=None):
        losses = []
        for i in range(2):
            reduced.clear()
            losses += _steps(train_step, state, images[rows], labels[rows], 1, seed=5 + i)
            rec_states.append(_snapshot(state))
            if counts is not None:
                counts.append(sum(reduced))
        return losses

    for leg, axes, sizes, optimizer, oracle_rank in (
            ("tp", ("data", "model"), (1, 2), "sgd", 1),
            ("fsdp_adamw", ("data",), (2,), "adamw", 0),
            ("fsdp_lamb", ("data",), (2,), "lamb", 1),
            ("dp_adamw", ("data",), (2,), "adamw", None)):
        mesh = create_mesh(axes, sizes)
        state = _vit_state(optimizer)
        rec[f"{leg}/whole_shapes"] = {n: tuple(p.shape) for n, p in state.model.named_parameters()}
        if leg != "dp_adamw":
            shard_train_state(state, mesh, min_size=MIN_SIZE, fsdp=leg != "tp")
        rec_states, counts = [], []
        dist.all_reduce = counting_all_reduce
        try:
            rec[f"{leg}/losses"] = run(shard_train_step(step, mesh), state, batch_rows(mesh, 8),
                                       counts)
        finally:
            dist.all_reduce = all_reduce
        rec[f"{leg}/states"], rec[f"{leg}/all_reduced"] = rec_states, counts
        if rank == oracle_rank:
            rec_states = []
            rec[f"{leg}/oracle_losses"] = run(step, _vit_state(optimizer), slice(None))
            rec[f"{leg}/oracle_states"] = rec_states


def _trainer_cfg(inp: dict, run_dir: str, mesh_shape: dict, sharding: str,
                 epochs: int) -> config.Config:
    cfg = config.Config()
    for k, v in inp["trainer_cfg"].items():
        section, key = k.split(".")
        setattr(getattr(cfg, section), key, v)
    cfg.train.epochs, cfg.runtime.out_dir = epochs, run_dir
    cfg.runtime.mesh_shape, cfg.runtime.param_sharding = mesh_shape, sharding
    return cfg


def trainer_legs(rank: int, inp: dict, out_dir: str, rec: dict) -> None:
    """The trainer at world 2, tp and fsdp: one epoch of the smoke config,
    then a resume for a second one. Each rank is given its own out_dir, so
    that what rank 1 writes shows. Then a SIGTERM that reaches rank 1 alone
    (its flag set after its first step): every rank stops there."""
    for leg, mesh_shape in (("tp", {"data": 1, "model": 2}), ("fsdp", {"data": 2})):
        run_dir = os.path.join(out_dir, f"trainer_{leg}_rank{rank}")
        for epochs in (1, 2):
            cfg = _trainer_cfg(inp, run_dir, mesh_shape, leg, epochs)
            if epochs == 2:
                cfg.runtime.resume = os.path.join(out_dir, f"trainer_{leg}_rank0", "checkpoints",
                                                  "step_2")
            trainer = Trainer(cfg, device="cpu")
            trainer.fit()
        rec[f"trainer/{leg}/dir"] = run_dir
        rec[f"trainer/{leg}/sharded"] = sorted(
            n for n, p in trainer.model.named_parameters() if hasattr(p, "_vtt_shard"))

    run_dir = os.path.join(out_dir, f"trainer_preempted_rank{rank}")
    trainer = Trainer(_trainer_cfg(inp, run_dir, {"data": 2}, "fsdp", 1), device="cpu")
    train_batch = trainer.train_batch

    def signalled_after_one_step(batch):
        metrics = train_batch(batch)
        trainer._preempted = trainer._preempted or rank == 1
        return metrics

    trainer.train_batch = signalled_after_one_step
    trainer.fit()
    rec["trainer/preempted"] = dict(dir=run_dir, step=trainer.state.step)


def refusals(rank: int, rec: dict) -> None:
    """A mesh whose product is not the world size, a batch that does not
    divide over the data axis, the device-resident store at world 2."""
    out = {}
    for case, make in (
            ("mesh_product", lambda: create_mesh(("data", "model"), (2, 2))),
            ("batch_remainder", lambda: batch_rows(create_mesh(("data",), (2,)), 15)),
            ("trainer_batch", lambda: Trainer(_cfg_with(batch_size=15), device="cpu")),
            ("device_resident", lambda: Trainer(_cfg_with(raw_shards=True, device_resident=True,
                                                          synthetic=False, train_dir="/absent"),
                                                device="cpu"))):
        try:
            make()
            out[case] = None
        except Exception as e:  # the type and message are the record
            out[case] = (type(e).__name__, str(e))
    rec["refusals"] = out


def _cfg_with(**data) -> config.Config:
    cfg = config.Config()
    cfg.model.backbone, cfg.model.num_classes = "mobilenet_v3_small", CLASSES
    cfg.data.synthetic, cfg.data.batch_size = True, 16
    cfg.runtime.mesh_shape = {"data": 2}
    cfg.runtime.out_dir = os.path.join(os.environ["VTT_MP_OUT"], "refused")
    for k, v in data.items():
        setattr(cfg.data, k, v)
    return cfg


def data_legs(rank: int, inp: dict, rec: dict) -> None:
    """The loaders' shards per data-axis coordinate, given as the trainer
    gives them: the raw-shard loader's rows, ``shard_for_host``'s list, the
    WebDataset loader's samples (two reader streams a rank), and the
    image-folder loaders' batches (``DataLoader`` for train and val,
    ``NativeJPEGLoader``; 4 rows a rank)."""
    ds = RawShardDataset(inp["raw_dir"])
    folder = ImageFolder(inp["image_folder"])
    shards = [f"shard_{i:03d}.tar" for i in range(7)]
    batches = lambda loader: [(np.asarray(im), np.asarray(lab)) for im, lab in loader]
    for leg, axes, sizes in (("data2", ("data",), (2,)), ("model2", ("data", "model"), (1, 2))):
        mesh = create_mesh(axes, sizes)
        shard = dict(process_index=mesh.coord("data"), process_count=mesh.axis_size("data"))
        loader = RawShardLoader(ds, 4, 16, training=False, **shard)
        wds = WebDatasetLoader(inp["wds_shards"], 4, training=False, num_streams=2,
                               transform=lambda r, im: np.asarray(im, np.float32) / 255.0,
                               **shard)
        train = DataLoader(folder, 4, seed_pixel, shuffle=True, drop_last=True, num_workers=2,
                           seed=3, **shard)
        val = DataLoader(folder, 4, seed_pixel, num_workers=2, **shard)
        rec[f"data/{leg}"] = dict(
            shard=(shard["process_index"], shard["process_count"]),
            shards=datasets.shard_for_host(shards, **shard),
            rows=(loader._lo, loader._hi),
            labels=np.concatenate([lab for _, lab in loader]).tolist(),
            wds_labels=np.concatenate([lab for _, lab in wds]).tolist(),
            folder_train=(len(train), batches(train)), folder_val=(len(val), batches(val)))
        if native_available():
            native = NativeJPEGLoader(folder, 4, 16, num_threads=2, seed=3, **shard)
            rec[f"data/{leg}"]["native"] = (len(native), batches(native))


def image_folder_trainer(rank: int, inp: dict, out_dir: str, rec: dict) -> None:
    """A trainer at {"data": 2} on the image folder (global batch 4): its
    steps per epoch, its loaders' shares and its eval over the val set."""
    cfg = image_folder_cfg(inp["image_folder"], os.path.join(out_dir, f"folder_rank{rank}"))
    cfg.runtime.mesh_shape = {"data": 2}
    trainer = Trainer(cfg, device="cpu")
    rec["folder_trainer"] = dict(
        steps_per_epoch=trainer.steps_per_epoch,
        shares=[(ld.process_index, ld.process_count)
                for ld in (trainer.train_loader, trainer.val_loader)],
        val_rows=sum(len(lab) for _, lab in trainer.val_loader), eval=trainer.evaluate())


def image_folder_cfg(folder: str, run_dir: str) -> config.Config:
    """The image-folder trainer's config (tests/test_torch_multiprocess.py
    builds its world-1 twin from it)."""
    cfg = config.Config()
    cfg.model.backbone, cfg.model.num_classes, cfg.model.bf16 = "mobilenet_v3_small", 23, False
    cfg.data.synthetic, cfg.data.train_dir, cfg.data.val_dir = False, folder, folder
    cfg.data.batch_size, cfg.data.num_workers = 4, 2
    cfg.data.train_crop_size, cfg.data.val_resize_size, cfg.data.val_crop_size = 32, 36, 32
    cfg.runtime.out_dir = run_dir
    return cfg


def main() -> None:
    rank, world, port, in_dir, out_dir = sys.argv[1:6]
    os.environ.update(RANK=rank, WORLD_SIZE=world, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                      VTT_MP_OUT=out_dir)
    rank = int(rank)
    rec: dict = {"rank": rank}
    init_process_group("cpu")
    inp = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    rec["world"] = dist.get_world_size()
    for leg in (lambda: dp_legs(rank, inp, rec), lambda: bn_leg(rank, rec),
                lambda: vit_legs(rank, rec), lambda: trainer_legs(rank, inp, out_dir, rec),
                lambda: refusals(rank, rec), lambda: data_legs(rank, inp, rec),
                lambda: image_folder_trainer(rank, inp, out_dir, rec)):
        leg()
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
