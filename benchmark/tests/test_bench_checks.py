"""What decides ``correct``, at CPU size: the program against the plain
reference, the run driven past the harness's look for a card with the timed
path broken underneath (each fault a cell can have), and the control."""

import pytest

import tiny
from benchmark.harness import compare, spec, train

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def test_program_follows_reference(root):
    _, run, line = tiny.measure(root, "vit_b_16.train.b128")
    n = run["numbers"]
    # bf16 compute against the f32 reference, at 8 images of 32 px
    assert n["loss_gap"] < 1e-3 and n["grad_gap"] < 0.02 and n["change_gap"] < 0.02
    assert list(line)[-1] == "checks" and "grad_spread" in line["checks"]


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_train_faults_fail(root, fault):
    _, _, line = tiny.measure(root, "vit_b_16.train.b128", fault=fault)
    assert line["correct"] is False


@pytest.mark.parametrize("fault", [None, "altered_answer", "scaled_answer"])
def test_serve_follows_reference_and_faults_fail(root, fault):
    """Sound runs pass; an answer altered where it is produced fails, and so
    does one scaled by 1.1, whose direction is right (the relative L2 gap
    catches it, the cosine distance cannot)."""
    _, run, line = tiny.measure(root, "vit_b_16.serve.b256", fault=fault)
    assert line["correct"] is (fault is None)
    if fault == "scaled_answer":
        assert run["numbers"]["feature_cos_gap"] < line["checks"]["feature_cos_gap"]["limit"]


def test_train_control_fails(root):
    """The reference with float8 products in the program's place fails the
    cell's limits."""
    import numpy as np
    import torch

    from benchmark.harness import weights

    cell = spec.load("vit_b_16.train.b128", root)
    cfg, traffic = cell.config, cell.traffic
    n, batch = traffic["store_images"], cfg["batch_size"]
    seed = 987654321987
    store = weights.images(seed, weights.STORE, n, cfg["store_px"], torch.device("cpu"))
    labels = torch.from_numpy(np.random.default_rng(5).integers(0, 1000, n).astype(np.int32))
    idx = [torch.arange(i * batch, (i + 1) * batch) for i in range(3)]
    readings = [train.reference(cfg["architecture"], cfg["recipe"], seed, store, labels, idx,
                                n // batch, torch.device("cpu"), fp8=fp8) for fp8 in (True, False)]
    correct, _ = compare.judge(compare.train_numbers(*readings), cell.limits)
    assert correct is False


def test_serve_control_fails(root):
    """The program's own int8 serving path fails the serve cell's limit."""
    _, run, line = tiny.measure(root, "vit_b_16.serve.b256", fault="int8")
    assert line["correct"] is False
