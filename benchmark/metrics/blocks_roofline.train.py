"""The fused half-blocks' least time (forward and backward, from shapes)
over the device time attributed to the ViT blocks (``bench:blocks``,
forward and the backward linked to it) in the profiled steps, in %."""

from benchmark.harness.flops import vit_blocks_least_seconds
from benchmark.harness.trace import has


def read(run):
    tr, arch = run.get("trace"), run["arch"]
    if tr is None or "steps" not in run or arch.get("reference") != "vit":
        return None
    spent = tr.seconds(has("bench:blocks"))
    if not spent:
        return None
    return 100.0 * tr.units * vit_blocks_least_seconds(arch, run["batch"], True) / spent
