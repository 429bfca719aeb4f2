"""The multi-rank dry run — the counterpart of the repo root's
``__graft_entry__.py`` ``dryrun_multichip``:

    python -m vision_toolbox_tpu_torch.parallel.dryrun --nproc N [--device cpu]

starts N processes, one rank each, in a ``torch.distributed`` world on
127.0.0.1 (NCCL on the cards, one card a rank: N above the card count
raises ``ValueError``; gloo with ``--device cpu``), and runs one sharded
train step of each leg over the N ranks, printing one line per leg from
rank 0, as JAX's does:

1. dp×tp: cspdarknet53 on ``{"data": N/2, "model": 2}`` (pure DP for N
   below 4 or odd), its big 2-D weights column-sharded over ``model``;
2. FSDP: darknet19 on ``{"data": N}``, parameters and optimizer state
   sharded over ``data``;
3. dp×pp: vit_ti_16 at 32 px on ``{"data": N/pp, "pipe": pp}`` (pp 4 or 2,
   where it divides N and the depth), interleave 3 where the depth splits
   into pp × 3 chunks, ``min(4, pp)`` microbatches (``parallel/pipeline.py``);
4. dp×sp: vit_b_16 at 64 px in its default cls-token config (T = 17,
   padded to 18) with ``token_sharding`` over ``{"data": N/2, "seq": 2}``
   (even N); the leg asserts that the K/V all-gathers ran and prints their
   count.

Each leg's global batch is 2N images of 100 classes, drawn from seeded
generators; the step is ``shard_train_step`` of the full recipe with SGD.
``run_legs`` is what each rank runs; the tests call it inside their gloo
cluster.
"""

from __future__ import annotations

import argparse
import math
import os
import socket

import torch
import torch.distributed as dist

CLASSES = 100


def _parts(model, mesh, size: int, seed: int, device: torch.device) -> tuple:
    """(train state with SGD, the full-recipe ``shard_train_step``, this
    rank's images and labels of a seeded global batch of 2·world images at
    ``size`` px) for ``model``."""
    from ..train import TrainState, make_train_step, sgd_with_param_groups, shard_train_step
    from ..train.optim import warmup_cosine_schedule
    from .mesh import batch_rows

    n = dist.get_world_size()
    gen = torch.Generator().manual_seed(seed)
    images = torch.rand(2 * n, size, size, 3, generator=gen)
    labels = torch.randint(0, CLASSES, (2 * n,), generator=gen)
    rows = batch_rows(mesh, 2 * n)
    schedule = warmup_cosine_schedule(0.5, total_epochs=100, steps_per_epoch=10)
    state = TrainState(model, sgd_with_param_groups(model, schedule, momentum=0.9,
                                                    weight_decay=2e-5))
    return state, shard_train_step(make_train_step(CLASSES), mesh), images[rows].to(device), \
        labels[rows].to(device)


def _run(state, step, images, labels, seed: int, device: torch.device) -> float:
    """One step with a generator of ``seed``; its global loss, finite."""
    g = torch.Generator(device=device).manual_seed(seed)
    loss = float(step(state, images, labels, g)["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return loss


def run_legs(device: torch.device | str = "cpu") -> list[dict]:
    """Every leg on this rank of the initialized world (each rank calls it,
    in step). Returns one record a leg: its mesh, loss and line."""
    from ..models.base import create_backbone
    from ..train import ImageClassifier
    from .mesh import GATHERS, TokenSharding, create_mesh
    from .pipeline import make_classifier_pipeline_apply
    from .sharding import shard_of, shard_train_state

    device = torch.device(device)
    n = dist.get_world_size()
    out = []

    def classifier(name: str, seed: int, **kw):
        gen = torch.Generator().manual_seed(seed)
        return ImageClassifier(create_backbone(name, device=device, generator=gen, **kw),
                               CLASSES, generator=gen)

    def record(leg: str, mesh, loss: float, line: str, **extra):
        out.append(dict(leg=leg, mesh=mesh.shape, loss=loss, line=line, **extra))
        if dist.get_rank() == 0:
            print(line, flush=True)

    tp = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = create_mesh(("data", "model"), (n // tp, tp)) if tp > 1 else create_mesh(("data",))
    parts = _parts(classifier("cspdarknet53", 0), mesh, 32, 1, device)
    if tp > 1:
        shard_train_state(parts[0], mesh, min_size=1024)
    loss = _run(*parts, 3, device)
    head = shard_of(parts[0].model.head.weight)
    record("dp_tp", mesh, loss,
           f"dryrun({n}): 1 train step ok over mesh {mesh.shape}, loss={loss:.4f}, head "
           f"sharding={'replicated' if head is None else (head.axis, head.dim)}")

    mesh = create_mesh(("data",))
    parts = _parts(classifier("darknet19", 4), mesh, 32, 1, device)
    shard_train_state(parts[0], mesh, fsdp=True, min_size=4096)
    loss = _run(*parts, 5, device)
    sharded = sum(shard_of(p) is not None for p in parts[0].model.parameters())
    record("fsdp", mesh, loss, f"dryrun({n}): FSDP leg ok over mesh {mesh.shape}, "
           f"loss={loss:.4f}, {sharded} parameters sharded over data", sharded=sharded)

    depth = 12  # vit_ti
    pp = next((p for p in (4, 2) if n % p == 0 and depth % p == 0), 1)
    if pp > 1:
        il = 3 if depth % (pp * 3) == 0 else 1
        mesh = create_mesh(("data", "pipe"), (n // pp, pp))
        model = make_classifier_pipeline_apply(classifier("vit_ti_16", 6, img_size=32), mesh,
                                               num_microbatches=min(4, pp), interleave=il)
        loss = _run(*_parts(model, mesh, 32, 1, device), 7, device)
        record("pp", mesh, loss,
               f"dryrun({n}): pipeline leg ok over mesh {mesh.shape} ({pp} stages x {il} "
               f"interleaved chunks x {depth // (pp * il)} layers, {min(4, pp)} microbatches), "
               f"loss={loss:.4f}, blocks held {model.owned}", owned=model.owned)

    sp = 2 if n % 2 == 0 else 1
    if sp > 1:
        mesh = create_mesh(("data", "seq"), (n // sp, sp))
        model = classifier("vit_b_16", 7, img_size=64, token_sharding=TokenSharding(mesh))
        parts = _parts(model, mesh, 64, 8, device)
        GATHERS.clear()
        loss = _run(*parts, 9, device)
        kv = GATHERS["kv"]
        if not kv:
            raise AssertionError("the sp leg ran no K/V all-gather")
        record("sp", mesh, loss,
               f"dryrun({n}): sp leg ok over mesh {mesh.shape} (vit_b_16 default cls-token "
               f"config, T=17 padded to 18), loss={loss:.4f}, {kv} K/V all-gathers a step",
               kv_gathers=kv)
    return out


def _worker(rank: int, n: int, port: int, device: str) -> None:
    from .mesh import init_process_group

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    init_process_group(device)
    try:
        run_legs(torch.device("cuda", rank) if device == "cuda" else device)
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m vision_toolbox_tpu_torch.parallel.dryrun")
    parser.add_argument("--nproc", type=int, required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if args.nproc > cards:
            raise ValueError(f"--nproc {args.nproc} needs as many cards, this machine has "
                             f"{cards}; pass --device cpu for gloo processes")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.multiprocessing.spawn(_worker, args=(args.nproc, port, args.device),
                                nprocs=args.nproc)


if __name__ == "__main__":
    main()
