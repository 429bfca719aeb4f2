"""Training CLI of the port — the counterpart of the repo root's ``train.py``:

    python -m vision_toolbox_tpu_torch.train fit --config configs/base.yaml
        [--config more.yaml] [--set train.lr=0.1 --set data.batch_size=256]
        [--device cuda|cpu]

Configs compose by later-file override; --set applies dotted overrides; the
final merged config is archived to <out_dir>/saved_config.yaml. ``validate``
prints the val metrics as one JSON object (restore a checkpoint first with
``--set runtime.resume=<out_dir>/checkpoints/step_<n>``). The device is the
card unless ``--device cpu`` is given; the CUDA kernels are built at first
use. Under a launcher, one process per device:

    torchrun --nproc_per_node N -m vision_toolbox_tpu_torch.train fit \
        --config configs/base.yaml --config configs/multichip.yaml

each process joins the launcher's ``torch.distributed`` world (NCCL on the
card, gloo with ``--device cpu``) before the trainer is built, and the mesh
of ``runtime.mesh_shape`` spans the world.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m vision_toolbox_tpu_torch.train",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("command", choices=["fit", "validate"], help="what to run")
    parser.add_argument("--config", action="append", default=[], help="YAML config (repeatable)")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        help="dotted override, e.g. train.lr=0.1")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from .config import load_config
    from .trainer import Trainer

    if "WORLD_SIZE" in os.environ:  # started by a launcher (torchrun)
        from ..parallel.mesh import init_process_group

        init_process_group(args.device)
    try:
        trainer = Trainer(load_config(args.config, args.overrides), device=args.device)
        if args.command == "fit":
            trainer.fit()
        else:
            metrics = trainer.evaluate()
            if trainer.rank == 0:
                print(json.dumps(metrics))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
