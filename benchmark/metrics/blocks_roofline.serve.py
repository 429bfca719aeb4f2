"""The fused half-blocks' least time (forward, from shapes) over the device
time of the served program's blocks (its ``vtt::fused_*`` half-block
operators, ``ops/block_attention.py`` and ``ops/block_mlp.py``) in the
profiled requests, in %."""

from benchmark.harness.flops import vit_blocks_least_seconds
from benchmark.harness.trace import has


def read(run):
    tr, arch = run.get("trace"), run["arch"]
    if tr is None or "requests" not in run or arch.get("reference") != "vit":
        return None
    spent = tr.seconds(has("bench:blocks", "vtt::fused_attention_block",
                           "vtt::fused_mlp_block"))
    if not spent:
        return None
    least = sum(vit_blocks_least_seconds(arch, s, False) for s in run["trace_sizes"])
    return 100.0 * least / spent
