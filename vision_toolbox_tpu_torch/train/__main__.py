"""Training CLI of the port — the counterpart of the repo root's ``train.py``:

    python -m vision_toolbox_tpu_torch.train fit --config configs/base.yaml
        [--config more.yaml] [--set train.lr=0.1 --set data.batch_size=256]
        [--device cuda|cpu]

Configs compose by later-file override; --set applies dotted overrides; the
final merged config is archived to <out_dir>/saved_config.yaml. ``validate``
prints the val metrics as one JSON object (restore a checkpoint first with
``--set runtime.resume=<out_dir>/checkpoints/step_<n>``). The device is the
card unless ``--device cpu`` is given; the CUDA kernels are built at first
use.
"""

from __future__ import annotations

import argparse
import json


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

    trainer = Trainer(load_config(args.config, args.overrides), device=args.device)
    if args.command == "fit":
        trainer.fit()
    else:
        print(json.dumps(trainer.evaluate()))


if __name__ == "__main__":
    main()
