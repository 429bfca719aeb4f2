"""The port's optimizers and schedule (vision_toolbox_tpu_torch/train/optim.py)
vs the JAX package's optax chains: the warmup-cosine schedule, the 3-group
split, SGD with momentum and per-group weight decay over three updates,
rmsprop / adamw / lamb / lars over five updates with all three decay groups,
and gradient accumulation against ``optax.MultiSteps``.

Tolerances: schedule rtol 1e-6 with atol 1e-8 (float32 cos in two
libraries: one ulp of the cosine shows near the end of the decay); parameters
and optimizer state rtol = atol = 1e-6 (the same separately rounded f32
chain; a lr read one ulp apart would show here; the trust ratios' norms sum
in another order, Adam's bias corrections are f32 powers in two libraries).
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

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
from vision_toolbox_tpu_torch import create_backbone
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
    pm = ImageClassifier(Darknet(32, stages, csp=True, device="cpu"), 10)
    pairs = _port_groups(pm, params["params"])
    assert {g for g, _ in pairs.values()} == {"norm", "bias", "other"}
    assert all(a == b for a, b in pairs.values()), pairs

    kw = dict(d_model=64, depth=1, n_heads=2, patch_size=8, img_size=16, pool_type="mha",
              cls_token=False, layer_scale_init=0.1)
    vparams = JaxViT(**kw).init_variables(0)["params"]
    pairs = _port_groups(ViT(**kw, device="cpu"), jax.tree.map(np.asarray, vparams))
    assert all(a == b for a, b in pairs.values()), pairs


@pytest.mark.parametrize("name", ["vit_ti_16", "deit_ti_16", "deit3_ti_16"])
def test_transformer_param_groups_match_jax(name):
    """Registry transformers (cls token, DeiT's dist token, DeiT3's γ) in a
    classifier: the same group for every parameter as the JAX package's
    ``param_group`` gives the flax leaf the bridge maps onto it."""
    jm = JaxClassifier(backbone=jvtt.create_backbone(name, img_size=32), num_classes=10)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)["params"]
    pm = ImageClassifier(create_backbone(name, img_size=32, device="cpu"), 10)
    pairs = _port_groups(pm, params)
    assert {g for g, _ in pairs.values()} == {"norm", "bias", "other"}
    assert all(a == b for a, b in pairs.values()), {n: p for n, p in pairs.items() if p[0] != p[1]}


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

    pm = ImageClassifier(Darknet(**NARROW, device="cpu"), 5)
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


def test_unknown_optimizer_raises():
    m = torch.nn.Linear(2, 2)
    for name in ("sgd", "rmsprop", "adamw", "lamb", "lars"):
        optim.make_optimizer(name, m, 0.1)
    with pytest.raises(ValueError, match="adagrad"):
        optim.make_optimizer("adagrad", m, 0.1)


DECAYS = dict(weight_decay=2e-3, norm_weight_decay=1e-3, bias_weight_decay=5e-4)
SCHEDULE = dict(base_lr=0.05, total_epochs=10, steps_per_epoch=1, warmup_epochs=2)


def _narrow_pair():
    """A narrow CSP Darknet classifier on both sides from one set of
    variables; its parameters fall in all three decay groups."""
    jm = JaxClassifier(backbone=JaxDarknet(**NARROW), num_classes=5)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    pm = ImageClassifier(Darknet(**NARROW, device="cpu"), 5)
    pm.load_state_dict(flax_to_state_dict(params), strict=False)
    groups = {optim.param_group(tuple(n.split("."))) for n, _ in pm.named_parameters()}
    assert groups == {"norm", "bias", "other"}, groups
    return params, pm


def _run_both(tx, opt, params, pm, steps):
    state = tx.init(params)
    update = jax.jit(tx.update)  # one trace, not an eager dispatch per leaf and op
    rng = np.random.default_rng(1)
    named = dict(pm.named_parameters())
    for _ in range(steps):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for name, g in flax_to_state_dict(grads).items():
            named[name].grad = g
        opt.step()
    for name, want in flax_to_state_dict(jax.tree.map(np.asarray, params)).items():
        np.testing.assert_allclose(named[name].detach().numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)
    return state


def _by_name(pm, opt, lists):
    names = {id(p): n for n, p in pm.named_parameters()}
    return {names[id(p)]: t for (_, ps), ts in zip(opt.groups, lists) for p, t in zip(ps, ts)}


def _held(pm, opt, lists, jax_tree):
    got = _by_name(pm, opt, lists)
    for name, want in flax_to_state_dict(jax.tree.map(np.asarray, jax_tree)).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


def _leaf_state(opt_state, kind):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, kind))
    return next(s for s in leaves if isinstance(s, kind))


@pytest.mark.parametrize("name", ["rmsprop", "adamw", "lamb", "lars"])
def test_optimizer_five_updates_match_optax(name):
    """Parameters after five updates from one schedule (warmup then cosine)
    and per-group decays, and the optimizer's state: RMSprop's ν and
    momentum trace, Adam's μ and ν, LARS's momentum trace."""
    params, pm = _narrow_pair()
    schedule_kw = SCHEDULE | (dict(base_lr=0.5) if name == "lars" else {})
    tx = joptim.make_optimizer(name, params, joptim.warmup_cosine_schedule(**schedule_kw),
                               momentum=0.9, **DECAYS)
    opt = optim.make_optimizer(name, pm, optim.warmup_cosine_schedule(**schedule_kw),
                               momentum=0.9, **DECAYS)
    state = _run_both(tx, opt, params, pm, 5)
    assert opt.count == 5
    if name == "rmsprop":
        _held(pm, opt, opt.nu, _leaf_state(state, optax.ScaleByRmsState).nu)
        _held(pm, opt, opt.trace, _trace(state))
    elif name == "lars":
        _held(pm, opt, opt.trace, _trace(state))
    else:
        adam = _leaf_state(state, optax.ScaleByAdamState)
        assert int(adam.count) == 5
        _held(pm, opt, opt.mu, adam.mu)
        _held(pm, opt, opt.nu, adam.nu)


@pytest.mark.parametrize("k", [2, 3])
def test_grad_accumulation_matches_multisteps(k):
    """SGD under ``optax.MultiSteps(every_k_schedule=k)`` for 7 micro-steps:
    the parameters (updated every k-th), the inner momentum trace, the
    running mean of the unfinished accumulation and the counts."""
    params, pm = _narrow_pair()
    schedule = dict(SCHEDULE, steps_per_epoch=2)
    tx = optax.MultiSteps(
        joptim.make_optimizer("sgd", params, joptim.warmup_cosine_schedule(**schedule),
                              momentum=0.9, **DECAYS), every_k_schedule=k,
    ).gradient_transformation()
    opt = optim.MultiSteps(
        optim.make_optimizer("sgd", pm, optim.warmup_cosine_schedule(**schedule), momentum=0.9,
                             **DECAYS), k)
    state = _run_both(tx, opt, params, pm, 7)
    assert (opt.count, opt.mini_step) == (7 // k, 7 % k)
    assert (int(state.gradient_step), int(state.mini_step)) == (7 // k, 7 % k)
    _held(pm, opt, opt.inner.buffers, _trace(state.inner_opt_state))
    _held(pm, opt, opt.acc, state.acc_grads)
