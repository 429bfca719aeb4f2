"""Device ms per step of the input pipeline: the step's work outside the
model's forward and backward, the optimizer and the loss (the gather, the
device crop, TrivialAugment with K1, RandomErasing, the draws, the mix)."""

from benchmark.harness.trace import BACKWARD


def _input(ctx):
    return ("bench:step" in ctx and BACKWARD not in ctx and "bench:model" not in ctx
            and "bench:optim" not in ctx and not any("train/classifier.py" in c for c in ctx))


def read(run):
    tr = run.get("trace")
    if tr is None or "steps" not in run:
        return None
    spent = tr.seconds(_input)
    return 1e3 * spent / tr.units if spent else None
