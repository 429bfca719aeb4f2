"""The fused half-blocks' least time (forward and backward, from shapes)
over the device time under the program's ``vtt:block`` spans
(``nn/attention.py`` ``ViTBlock``; the backward linked to its forward by the
profiler's sequence numbers) in the profiled steps, in %. The twin of
``blocks_roofline.train``, read from inside the program."""

from benchmark.harness.flops import vit_blocks_least_seconds


def read(run):
    tr, arch = run.get("trace"), run["arch"]
    if tr is None or "steps" not in run or arch.get("reference") != "vit":
        return None
    spent = tr.seconds(lambda ctx: "vtt:block" in ctx)
    if not spent:
        return None
    return 100.0 * tr.units * vit_blocks_least_seconds(arch, run["batch"], True) / spent
