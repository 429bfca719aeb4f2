"""Read the numbers that decide ``correct`` over many seeds in one process:
the program's (a short window each), or the control's, to set a cell's
limits from (``limits/<cell>.json``).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --what program
    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --what control

The control of a train cell is the plain reference with float8 products in
the program's place, on the steps the program's feed would give; of a serve
cell, the program's own int8 serving path. ``--what witness`` reads the
plain reference under bf16 autocast against its f32 self (a train cell): a
plain bf16 path's rounding, beside the program's. ``--fault`` plants one of the
faults the tests plant and reads it at the cell's size. Prints one JSON line
a seed; ``--leaves N`` adds the N worst leaves of a train cell.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as bench_run  # noqa: F401  (sets the cache directories and the import path)


def control_train(cell, seed: int, dev, low: str = "fp8") -> tuple[dict, dict]:
    """(lower-precision readings, f32 readings) of the reference on the
    steps that the program's device-resident feed gives at this seed;
    ``low`` is float8 products (``fp8``) or bf16 autocast (``bf16``)."""
    import contextlib

    import numpy as np
    import torch

    from benchmark.harness import train, weights

    cfg, traffic = cell.config, cell.traffic
    arch, recipe, batch = cfg["architecture"], cfg["recipe"], cfg["batch_size"]
    n = traffic["store_images"]
    store = weights.images(seed, weights.STORE, n, cfg["store_px"], dev.device)
    g = np.random.default_rng(weights.sub_seed(seed, weights.STORE))
    labels = torch.from_numpy(g.integers(0, arch["num_classes"], n).astype(np.int32))
    # the feed's first epoch: a permutation seeded by (seed, epoch 0)
    order = np.random.default_rng([seed, 0]).permutation(n).astype(np.int32)
    idx = [torch.from_numpy(order[i * batch:(i + 1) * batch])
           for i in range(traffic["checked_steps"])]
    out = []
    for lower in (True, False):
        bf16 = lower and low == "bf16"
        ctx = torch.autocast(dev.device.type, torch.bfloat16) if bf16 else contextlib.nullcontext()
        with ctx:
            out.append(train.reference(arch, recipe, seed, store, labels, idx, n // batch,
                                       dev.device, fp8=lower and low == "fp8"))
    return out[0], out[1]


def worst_leaves(prog: dict, ref: dict, key: str, n: int) -> list:
    import statistics

    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    keep = [k for k, v in grads.items() if v >= 1e-3 * med]
    m = statistics.median(ref[key][k] for k in keep)
    gaps = sorted(((abs(prog[key][k] - ref[key][k]) / max(ref[key][k], m), k, prog[key][k],
                    ref[key][k]) for k in keep), reverse=True)
    return gaps[:n]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", choices=("program", "control", "witness"), default="program")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", choices=("frozen_state", "half_batch", "altered_answer",
                                       "scaled_answer"),
                   help="plant a fault in the timed path (its reading, for the limits)")
    p.add_argument("--leaves", type=int, default=0)
    args = p.parse_args()

    from benchmark.harness import compare, spec

    cell = spec.load(args.workload)
    dev = bench_run.Device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed, "what": args.what, "fault": args.fault}
        if cell.traffic["kind"] == "train" and args.what != "program":
            low, ref = control_train(cell, seed, dev,
                                     "bf16" if args.what == "witness" else "fp8")
            line["numbers"] = compare.train_numbers(low, ref)
            pair = low, ref
        else:
            bench_run.T_START = time.perf_counter()
            fault = "int8" if args.what == "control" else args.fault
            out = bench_run.measure(cell, seed, args.seconds, False, dev, fault)
            line["numbers"] = out["numbers"]
            pair = out.get("readings")
        if args.leaves and pair is not None:
            line["losses"] = [pair[0]["losses"], pair[1]["losses"]]
            for key in ("grad_norms", "change_norms"):
                line[key] = worst_leaves(*pair, key, args.leaves)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        dev.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
