"""How far the port's trainer moves with torch's CPU thread count, against
the JAX trainer: the smoke fit of ``tests/test_torch_trainer.py``'s
``test_trainer_matches_jax`` (darknet19, 10 classes, bs16@32, f32,
synthetic data, no draws), one JAX fit, then the port from the JAX fit's
initial variables at each thread count, each in a process of its own.

    python scripts/trainer_thread_spread.py [--threads 1 2 3 4 6 8] [--out DIR]

Prints, per logged loss (10 train/loss records and val/loss), JAX's value,
the port's at each thread count, the port's spread (max − min over the
thread counts) and its gap from JAX at one thread, both relative to JAX's
value. Runs on the CPU; imports JAX (it is a test-side measurement).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _smoke(cfg, out_dir: str):
    cfg.model.backbone, cfg.model.num_classes, cfg.model.bf16 = "darknet19", 10, False
    cfg.data.synthetic, cfg.data.batch_size = True, 16
    cfg.data.train_crop_size = cfg.data.val_crop_size = 32
    cfg.data.trivial_augment, cfg.data.random_erasing_p = False, 0.0
    cfg.train.epochs = cfg.train.warmup_epochs = 1
    cfg.train.mixup_alpha = cfg.train.cutmix_alpha = 0.0
    cfg.runtime.out_dir, cfg.runtime.log_every = out_dir, 1
    cfg.runtime.checkpoint_every_epochs = 2
    return cfg


def _losses(out_dir: str) -> list[float]:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [r.get("train/loss", r.get("val/loss")) for r in records
            if "train/loss" in r or "val/loss" in r]


def run_jax(out: Path) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from vision_toolbox_tpu.train import config
    from vision_toolbox_tpu.train.trainer import Trainer
    from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

    trainer = Trainer(_smoke(config.Config(), str(out / "jax")))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    init = flax_to_state_dict(to_np(trainer.state.params), to_np(trainer.state.batch_stats))
    trainer.fit()
    with open(out / "jax.pkl", "wb") as f:
        pickle.dump({"init": {k: v.numpy() for k, v in init.items()},
                     "losses": _losses(str(out / "jax"))}, f)


def run_port(out: Path, threads: int) -> None:
    import torch

    torch.set_num_threads(threads)
    from vision_toolbox_tpu_torch.train import config
    from vision_toolbox_tpu_torch.train.trainer import Trainer

    with open(out / "jax.pkl", "rb") as f:
        init = pickle.load(f)["init"]
    trainer = Trainer(_smoke(config.Config(), str(out / f"port{threads}")), device="cpu")
    trainer.state.model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    trainer.fit()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--threads", type=int, nargs="+", default=[1, 2, 3, 4, 6, 8])
    parser.add_argument("--out", default=None, help="work directory (default: a temporary one)")
    parser.add_argument("--role", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    out = Path(args.out or tempfile.mkdtemp(prefix="thread_spread_"))
    if args.role == "jax":
        return run_jax(out)
    if args.role is not None:
        return run_port(out, int(args.role))
    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    env["PYTHONPATH"] = str(ROOT)
    for role in ["jax", *map(str, args.threads)]:
        subprocess.run([sys.executable, __file__, "--out", str(out), "--role", role],
                       check=True, env=env, stdout=subprocess.DEVNULL)
    with open(out / "jax.pkl", "rb") as f:
        want = pickle.load(f)["losses"]
    got = {n: _losses(str(out / f"port{n}")) for n in args.threads}
    print("record  jax        " + "  ".join(f"{n:>2} threads" for n in args.threads)
          + "   spread     gap(1 thread)")
    for i, w in enumerate(want):
        vals = [got[n][i] for n in args.threads]
        spread = (max(vals) - min(vals)) / abs(w)
        gap = abs(got[args.threads[0]][i] - w) / abs(w)
        name = f"step {i + 1}" if i < len(want) - 1 else "val"
        print(f"{name:7s} {w:.7f}  " + "  ".join(f"{v:.7f}" for v in vals)
              + f"   {spread:.3e}  {gap:.3e}")


if __name__ == "__main__":
    main()
