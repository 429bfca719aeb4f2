"""Device ms per step of the optimizer's update (``train/optim.py``;
``bench:optim``)."""

from benchmark.harness.trace import has


def read(run):
    tr = run.get("trace")
    if tr is None or "steps" not in run:
        return None
    spent = tr.seconds(has("bench:optim"))
    return 1e3 * spent / tr.units if spent else None
