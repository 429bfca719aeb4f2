"""The train window's model operations (3 × the plain reference's forward
per image, no recompute) over its time × the bf16 peak, in %."""

from benchmark.harness.flops import PEAK_BF16_FLOPS


def read(run):
    if "steps" not in run:
        return None
    return 100.0 * run["flops_per_image"] * run["images"] / (run["window_s"] * PEAK_BF16_FLOPS)
