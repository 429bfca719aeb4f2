"""The yardstick's arithmetic against hand counts, and the end-to-end and
per-layer readers on synthetic timings."""

import math

import pytest

import tiny  # noqa: F401  (the import path)
from benchmark.harness import compare, flops, spec, trace
from benchmark.reference import models

VIT = dict(reference="vit", num_layers=12, hidden_size=768, mlp_dim=3072, num_heads=12,
           patch_size=16, image_size=224, num_classes=1000)


def vit_forward_by_hand(b=1):
    t, d, m, p = 197, 768, 3072, 16
    block = 2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d + 2 * 2 * t * d * m
    return b * (12 * block + 2 * 196 * (3 * p * p) * d)


def test_vit_b_16_forward_is_35_1_gflop():
    counted = flops.forward_flops(models.build(VIT, classifier=False, device="meta"),
                                  (1, 224, 224, 3))
    assert counted == vit_forward_by_hand()
    assert round(counted / 1e9, 1) == 35.1
    with_head = flops.forward_flops(models.build(VIT, classifier=True, device="meta"),
                                    (4, 224, 224, 3))
    assert with_head == 4 * (counted + 2 * 768 * 1000)


def test_halfblock_least_time_by_hand():
    b, t, d, m = 128, 197, 768, 3072
    parts = flops.vit_halfblocks(b, t, d, m)
    attn_fwd = 2 * b * t * 4 * d * d + 4 * b * t * t * d
    mlp_fwd = 4 * b * t * d * m
    assert parts["attention.fwd"][0] == attn_fwd and parts["attention.bwd"][0] == 2 * attn_fwd
    assert parts["mlp.fwd"][0] == mlp_fwd and parts["mlp.bwd"][0] == 2 * mlp_fwd
    act = b * t * d * 2
    assert parts["mlp.fwd"][1] == 2 * act + (2 * d * m + m + d + 2 * d) * 4
    # compute-bound at these shapes: the least time is operations / peak
    least = flops.vit_blocks_least_seconds(VIT, b, True)
    assert least == pytest.approx(12 * 3 * (attn_fwd + mlp_fwd) / flops.PEAK_BF16_FLOPS)
    assert flops.vit_blocks_least_seconds(VIT, b, False) == pytest.approx(least / 3)


def _read(name, run):
    return spec.reader(name)(run)


def _readings(scale, noise):
    """Three steps' losses and 9 leaves' norms, the reference's all 1; the
    program's leaf i reads ``scale`` × (1 + ``noise`` × (i − 4))."""
    ref = {f"leaf{i}": 1.0 for i in range(9)}
    prog = {f"leaf{i}": scale * (1.0 + noise * (i - 4)) for i in range(9)}
    side = lambda norms: {"losses": [7.0, 6.9, 6.8], "grad_norms": norms,  # noqa: E731
                          "change_norms": norms}
    return side(prog), side(ref)


def test_grad_spread_leaves_out_a_common_factor():
    """A factor every leaf shares moves the worst leaf and not the spread;
    leaves off by themselves move both."""
    common = compare.train_numbers(*_readings(1.002, 0.0))
    assert common["grad_gap"] == pytest.approx(0.002)
    assert common["grad_spread"] == pytest.approx(0.0, abs=1e-12)
    own = compare.train_numbers(*_readings(1.0, 0.001))
    # signed gaps −4..4 thousandths: the median 0, the spread 2 thousandths
    assert own["grad_spread"] == pytest.approx(0.002) and own["grad_gap"] == pytest.approx(0.004)
    both = compare.train_numbers(*_readings(1.002, 0.001))
    assert both["grad_spread"] == pytest.approx(1.002 * 0.002)
    nan = compare.train_numbers(*_readings(float("nan"), 0.0))
    assert nan["grad_spread"] == math.inf


def test_train_ips_counts_a_stall():
    steady = {"steps": 100, "images": 12800, "window_s": 5.0}
    stalled = {**steady, "window_s": 5.0 + 0.5}  # the same steps and one half-second stall
    assert _read("train_ips", steady) == pytest.approx(2560.0)
    assert _read("train_ips", stalled) == pytest.approx(12800 / 5.5)
    assert _read("train_ips", {"requests": 3, "images": 3, "window_s": 1.0}) is None


def test_serve_p95_counts_a_stall():
    lat = [0.010] * 95 + [0.012] * 5
    base = _read("serve_p95_ms", {"latencies": lat})
    stalled = list(lat)
    for i in range(0, 100, 10):  # one stalled request in ten
        stalled[i] = 0.050
    assert base == pytest.approx(10.1, abs=0.2)
    assert _read("serve_p95_ms", {"latencies": stalled}) == pytest.approx(50.0)
    assert _read("serve_ips", {"requests": 100, "images": 6000, "window_s": 2.0}) == 3000.0


def _trace():
    fwd = ("aten::mm", "bench:blocks", "bench:model", "bench:step")
    bwd = ("aten::mm", "FusedMLPFunctionBackward", trace.BACKWARD) + fwd
    kernels = [trace.Kernel("gemm", 0.004, fwd), trace.Kernel("gemm_bwd", 0.008, bwd),
               trace.Kernel("warp", 0.001, ("aten::copy_", "bench:step")),
               trace.Kernel("loss", 0.0005, ("aten::log_softmax",
                                             "vision_toolbox_tpu_torch/train/classifier.py(40)",
                                             "bench:step")),
               trace.Kernel("sgd", 0.002, ("aten::_foreach_add_", "bench:optim", "bench:step"))]
    # two steps: busy 0.010 s of each 0.012 s step, the streams overlapping
    intervals = [(0.0, 0.006, "a"), (0.004, 0.010, "b"), (0.012, 0.022, "c")]
    return trace.Trace(units=2, window_s=0.030, busy_s=trace.union_seconds(
        [(a, b) for a, b, _ in intervals]), kernels=kernels, intervals=intervals)


def test_union_and_per_layer_readers():
    tr = _trace()
    assert tr.busy_s == pytest.approx(0.020)
    run = {"trace": tr, "steps": 50, "window_s": 0.6, "batch": 128, "images": 6400,
           "arch": VIT, "flops_per_image": 3 * 35.1e9}
    assert _read("optim_ms.train", run) == pytest.approx(1.0)
    assert _read("input_ms.train", run) == pytest.approx(0.5)  # the warp, not the loss
    assert _read("idle.train", run) == pytest.approx(100 * (1 - 0.010 / 0.012))
    least = flops.vit_blocks_least_seconds(VIT, 128, True)
    assert _read("blocks_roofline.train", run) == pytest.approx(100 * 2 * least / 0.012)
    assert _read("mfu.train", run) == pytest.approx(
        100 * 3 * 35.1e9 * 6400 / (0.6 * flops.PEAK_BF16_FLOPS))
    # nothing to read: no value, never 0
    empty = trace.Trace(units=2, window_s=0.03, busy_s=0.0, kernels=[], intervals=[])
    assert _read("optim_ms.train", {**run, "trace": empty}) is None
    assert _read("blocks_roofline.train", {**run, "trace": empty}) is None
    assert _read("blocks_roofline.train", {**run, "arch": {**VIT, "reference": "cnn"}}) is None


def test_device_ops_and_gaps():
    tr = _trace()
    assert tr.device_ops(2) == [["c", pytest.approx(0.010)], ["a", pytest.approx(0.006)]]
    host = [trace._Span("aten::item", 0.009, 0.013)]
    gaps = trace._idle_gaps(tr.intervals, host)
    assert gaps == [("aten::item", pytest.approx(0.002))]
    assert math.isclose(trace.union_seconds([(0, 1), (0.5, 2), (3, 4)]), 3.0)
