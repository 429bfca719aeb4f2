"""The port's Darknet family (vision_toolbox_tpu_torch/models/darknet.py) vs
the JAX package's: the backbone contract for all eight names, and forward
parity of bridged variables in train mode (with the BatchNorm running-stat
update) and eval mode.

Narrow variants at 32 px keep it fast; inputs and variables are the JAX
package's, carried over as numpy. Tolerance: f32 at rtol = atol = 1e-4
(only f32 summation order differs: convolutions and batch statistics).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vision_toolbox_tpu as jvtt
from vision_toolbox_tpu.models.darknet import Darknet as JaxDarknet
from vision_toolbox_tpu.models.darknet import DarknetYOLOv5 as JaxYOLOv5
from vision_toolbox_tpu.train.classifier import ImageClassifier as JaxClassifier
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models.darknet import Darknet, DarknetYOLOv5
from vision_toolbox_tpu_torch.train import ImageClassifier
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

NAMES = ["cspdarknet53", "darknet19", "darknet53"] + [f"darknet_yolov5{v}" for v in "nsmlx"]
TOL = 1e-4

NARROW = {
    "csp": (dict(stem_channels=8, stage_configs=((1, 16), (2, 32)), csp=True), Darknet, JaxDarknet),
    "plain": (dict(stem_channels=8, stage_configs=((0, 16), (2, 24))), Darknet, JaxDarknet),
    "yolov5": (dict(stem_channels=8, stage_configs=((1, 16), (1, 32))), DarknetYOLOv5, JaxYOLOv5),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_registry_has_every_darknet_name():
    assert sorted(n for n in list_backbones() if "darknet" in n) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_contract_matches_jax(name):
    pm, jm = create_backbone(name), jvtt.create_backbone(name)
    assert pm.out_channels_list == jm.out_channels_list
    assert pm.stride == jm.stride
    with torch.no_grad():
        feats = pm.get_feature_maps(torch.zeros(1, 64, 64, 3))
    want = jax.eval_shape(lambda: jm.init_with_output(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), method=jm.get_feature_maps)[0])
    assert [tuple(f.shape) for f in feats] == [tuple(w.shape) for w in want]
    assert pm(torch.zeros(1, 64, 64, 3)).shape == feats[-1].shape


@pytest.mark.parametrize("variant", list(NARROW))
def test_forward_train_and_eval_match_jax(variant):
    kw, port_cls, jax_cls = NARROW[variant]
    jm = jax_cls(**kw)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    # non-trivial BN parameters and statistics on both sides
    rng = np.random.default_rng(0)
    perturb = lambda t: jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), _np(t))
    variables = {"params": perturb(variables["params"]),
                 "batch_stats": jax.tree.map(np.abs, perturb(variables["batch_stats"]))}
    pm = port_cls(**kw)
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]),
                       strict=True)
    x = rng.random((3, 32, 32, 3), dtype=np.float32)

    want, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = pm(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    stats = flax_to_state_dict({}, _np(mutated["batch_stats"]))
    for name, value in stats.items():
        np.testing.assert_allclose(pm.state_dict()[name].numpy(), value.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)

    new_vars = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    want = jm.apply(new_vars, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_bridge_loads_a_whole_jax_classifier_strictly():
    """``ImageClassifier(cspdarknet53)``: every param and BN statistic maps
    onto a port name and shape."""
    jm = JaxClassifier(backbone=jvtt.create_backbone("cspdarknet53"), num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(zeros["params"], zeros["batch_stats"])
    pm = ImageClassifier(create_backbone("cspdarknet53"), 1000)
    result = pm.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert len(sd) == len(pm.state_dict())


def test_bf16_compute_keeps_f32_params():
    m = create_backbone("cspdarknet53", dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in m.parameters())
    small = Darknet(**NARROW["csp"][0], dtype=torch.bfloat16)
    with torch.no_grad():
        out = small(torch.rand(2, 32, 32, 3), train=True)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
