"""Device ms per step under the program's own input spans: ``vtt:draws``
and ``vtt:input`` (``train/step.py``: the draws, the gather, the device
crop, TrivialAugment with K1, RandomErasing, the mix), backward left out.
The twin of ``input_ms.train``, read from inside the program."""

from benchmark.harness.trace import BACKWARD

SPANS = ("vtt:draws", "vtt:input")


def _input(ctx):
    return BACKWARD not in ctx and any(c in SPANS for c in ctx)


def read(run):
    tr = run.get("trace")
    if tr is None or "steps" not in run:
        return None
    spent = tr.seconds(_input)
    return 1e3 * spent / tr.units if spent else None
