"""The numbers that decide ``correct``, each held to its limit.

Training (the first steps of the window's own object, against the plain
reference following the same steps):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap of gradient norms, |‖g‖ − ‖g_ref‖|,
  over the larger of its reference norm and the median leaf's; the first
  step's gradient as the optimizer got it;
- ``change_gap``: the same for the norm of each leaf's change over the steps;
- ``grad_spread``: each leaf's signed gap of first-gradient norms, over the
  same denominator, taken about the median leaf's signed gap: the median of
  |gap − median gap|. A factor that the loss's gradient gives every leaf
  alike is left out; what stays is the leaves' own rounding, steady from
  seed to seed where the worst leaf swings.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's move by round-off alone and are left out of both leaf numbers.

Serving, over a sample of the requests the window served:
``feature_gap``, the worst image's relative L2 gap of its features, and
``feature_cos_gap``, the worst image's cosine distance.

A cell's limits file names the numbers compared; PERF.md says why each
other number is not.
"""

from __future__ import annotations

import math
import statistics

import torch


def _worst(gaps) -> float:
    gaps = list(gaps)
    return math.inf if any(math.isnan(g) for g in gaps) else max(gaps)


def _signed_gaps(prog: dict[str, float], ref: dict[str, float], keep: set[str]) -> list[float]:
    med = statistics.median(ref[k] for k in keep)
    return [(prog[k] - ref[k]) / max(ref[k], med) for k in keep]


def _leaf_gaps(prog: dict[str, float], ref: dict[str, float], keep: set[str]) -> list[float]:
    return [abs(g) for g in _signed_gaps(prog, ref, keep)]


def _spread(gaps: list[float]) -> float:
    if any(math.isnan(g) for g in gaps):
        return math.inf
    mid = statistics.median(gaps)
    return statistics.median(abs(g - mid) for g in gaps)


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    keep = {k for k, v in grads.items() if v >= 1e-3 * med}
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    return {"loss_gap": _worst(loss),
            "grad_gap": _worst(_leaf_gaps(prog["grad_norms"], grads, keep)),
            "change_gap": _worst(_leaf_gaps(prog["change_norms"], ref["change_norms"], keep)),
            "grad_spread": _spread(_signed_gaps(prog["grad_norms"], grads, keep))}


def feature_gaps(out: torch.Tensor, ref: torch.Tensor) -> list[tuple[float, float]]:
    """Each image's (relative L2 gap, cosine distance 1 − cos) of its
    features to the reference's."""
    out, ref = out.double(), ref.double()
    l2 = (out - ref).norm(dim=-1) / ref.norm(dim=-1)
    cos = 1.0 - torch.nn.functional.cosine_similarity(out, ref, dim=-1)
    return list(zip(l2.tolist(), cos.tolist()))


def serve_numbers(gaps: list[tuple[float, float]]) -> dict[str, float]:
    """``feature_gap``: the worst image's relative L2 gap; ``feature_cos_gap``:
    the worst image's cosine distance."""
    if not gaps:
        return {"feature_gap": math.inf, "feature_cos_gap": math.inf}
    return {"feature_gap": _worst(g for g, _ in gaps),
            "feature_cos_gap": _worst(c for _, c in gaps)}


def judge(numbers: dict[str, float], limits: dict | None) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that the
    cell's limits name; without limits every number, and not correct."""
    if not limits:
        return False, {k: {"value": v, "limit": None} for k, v in numbers.items()}
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v} for k, v in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
