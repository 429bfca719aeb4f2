"""The port's optimizer and schedule (vision_toolbox_tpu_torch/train/optim.py)
vs the JAX package's optax chain: the warmup-cosine schedule, the 3-group
split, and SGD with momentum and per-group weight decay over three updates.

Tolerances: schedule rtol 1e-6 with atol 1e-8 (float32 cos in two
libraries: one ulp of the cosine shows near the end of the decay); parameters
and momentum buffers rtol = atol = 1e-6 (the same separately rounded f32
chain; a lr read one ulp apart would show here).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import vision_toolbox_tpu as jvtt
from vision_toolbox_tpu.models.darknet import Darknet as JaxDarknet
from vision_toolbox_tpu.models.vit import ViT as JaxViT
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import optim as joptim
from vision_toolbox_tpu_torch.models.darknet import Darknet
from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.train import ImageClassifier, optim
from vision_toolbox_tpu_torch.utils.jax_bridge import _convert, _flatten, flax_to_state_dict

TOL = 1e-6
NARROW = dict(stem_channels=8, stage_configs=((1, 16), (1, 32)), csp=True)


@pytest.mark.parametrize("granular", [True, False])
@pytest.mark.parametrize("warmup", [0, 5])
def test_schedule_matches_jax(granular, warmup):
    kw = dict(base_lr=0.125, total_epochs=20, steps_per_epoch=7, warmup_epochs=warmup,
              decay_factor=0.01, epoch_granularity=granular)
    want_fn, got_fn = joptim.warmup_cosine_schedule(**kw), optim.warmup_cosine_schedule(**kw)
    steps = np.arange(0, 160, 3)
    want = np.asarray(jax.vmap(want_fn)(jnp.asarray(steps, jnp.int32)))
    got = np.array([got_fn(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-8)


def _port_groups(model, jax_params):
    """Each port parameter's group, and the JAX group of the flax leaf that
    the bridge maps onto it."""
    jax_group = {}
    for path, value in _flatten(jax_params):
        jax_group[_convert(path, value)[0]] = joptim.param_group(path)
    return {n: (optim.param_group(tuple(n.split("."))), jax_group[n])
            for n, _ in model.named_parameters()}


def test_param_groups_match_jax():
    """cspdarknet53 classifier (BN) and a ViT with MAP pooling and
    LayerScale (LN, γ, probe): same group for every parameter."""
    jm = JaxClassifier(backbone=jvtt.create_backbone("cspdarknet53"), num_classes=10)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    stages = ((1, 64), (2, 128), (8, 256), (8, 512), (4, 1024))
    pm = ImageClassifier(Darknet(32, stages, csp=True), 10)
    pairs = _port_groups(pm, params["params"])
    assert {g for g, _ in pairs.values()} == {"norm", "bias", "other"}
    assert all(a == b for a, b in pairs.values()), pairs

    kw = dict(d_model=64, depth=1, n_heads=2, patch_size=8, img_size=16, pool_type="mha",
              cls_token=False, layer_scale_init=0.1)
    vparams = JaxViT(**kw).init_variables(0)["params"]
    pairs = _port_groups(ViT(**kw), jax.tree.map(np.asarray, vparams))
    assert all(a == b for a, b in pairs.values()), pairs


def _trace(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    return next(s for s in leaves if isinstance(s, optax.TraceState)).trace


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_three_updates_match_optax(nesterov):
    jm = JaxClassifier(backbone=JaxDarknet(**NARROW), num_classes=5)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    schedule_kw = dict(base_lr=0.5, total_epochs=10, steps_per_epoch=1, warmup_epochs=2)
    wd = dict(weight_decay=2e-3, norm_weight_decay=1e-3, bias_weight_decay=5e-4)
    tx = joptim.sgd_with_param_groups(params, joptim.warmup_cosine_schedule(**schedule_kw),
                                      momentum=0.9, nesterov=nesterov, **wd)
    state = tx.init(params)

    pm = ImageClassifier(Darknet(**NARROW), 5)
    pm.load_state_dict(flax_to_state_dict(params), strict=False)
    opt = optim.sgd_with_param_groups(pm, optim.warmup_cosine_schedule(**schedule_kw),
                                      momentum=0.9, nesterov=nesterov, **wd)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        named = dict(pm.named_parameters())
        for name, g in flax_to_state_dict(grads).items():
            named[name].grad = g
        opt.step()
    assert opt.count == 3
    for name, want in flax_to_state_dict(jax.tree.map(np.asarray, params)).items():
        np.testing.assert_allclose(dict(pm.named_parameters())[name].detach().numpy(),
                                   want.numpy(), rtol=TOL, atol=TOL, err_msg=name)
    names = {id(p): n for n, p in pm.named_parameters()}
    bufs = {names[id(p)]: b for (_, ps), bs in zip(opt.groups, opt.buffers)
            for p, b in zip(ps, bs)}
    for name, want in flax_to_state_dict(jax.tree.map(np.asarray, _trace(state))).items():
        np.testing.assert_allclose(bufs[name].numpy(), want.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_only_sgd_is_ported():
    m = torch.nn.Linear(2, 2)
    for name in ("rmsprop", "adamw", "lamb", "lars"):
        with pytest.raises(NotImplementedError, match="sgd"):
            optim.make_optimizer(name, m, 0.1)
    with pytest.raises(ValueError):
        optim.make_optimizer("adagrad", m, 0.1)
