"""The port's full-recipe train step (vision_toolbox_tpu_torch/train/step.py)
vs the JAX package's ``make_train_step`` + ``sgd_with_param_groups``: one
and two steps of a narrow CSP Darknet (stem 8, stages (1, 16), (1, 32)) with
an ImageClassifier head, 32 px, batch 8, uint8 images; TrivialAugment,
RandomErasing, CutMix⊕MixUp, label smoothing 0.1, SGD momentum 0.9 with
3-group weight decay, warmup-cosine. Then the mask-aware eval step.

Both sides start from the same variables (bridged) and use the same draws:
the JAX draws are recomputed from its key (tests/torch_draws.py). The JAX
side's TrivialAugment warp is pointed at its shear3 kernel in interpret mode
(on CPU its ``affine_warp`` would take the 2-D gather, the port's takes the
shear3 warp for square images everywhere); nothing in the JAX package
changes.

Tolerances. f32 compute: rtol = atol = 1e-4 on the loss and on every
parameter, momentum buffer and BN statistic (f32 summation order). bf16
compute: rel L2 ≤ 1e-2 on the loss, on the head's momentum buffers, and over
all parameters and all BN statistics taken together. The backbone's bf16
gradients are noise-dominated in both packages (the BN backward cancels in
bf16: at batch 8 each package's bf16 gradient is 20-50% per tensor from its
f32 gradient), so the momentum buffers as a whole are held to the JAX
package's own bf16 error: rel L2(port, JAX) ≤ rel L2(JAX bf16, JAX f32)
(measured 0.14 against 0.3).
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
import torch
from torch_draws import step_draws

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.warp as jwarp
from vision_toolbox_tpu.models.darknet import Darknet as JaxDarknet
from vision_toolbox_tpu.ops.warp_pallas import shear3_warp_pallas
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_eval_step as jax_eval_step
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu.train import warmup_cosine_schedule as jax_schedule
from vision_toolbox_tpu_torch.models.darknet import Darknet
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_eval_step,
    make_train_step,
    sgd_with_param_groups,
    warmup_cosine_schedule,
)
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

NARROW = dict(stem_channels=8, stage_configs=((1, 16), (1, 32)), csp=True)
CLASSES, SHAPE = 10, (8, 32, 32, 3)
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0, trivial_augment=True,
              random_erasing_p=0.5)
SCHEDULE = dict(base_lr=0.5, total_epochs=100, steps_per_epoch=1, warmup_epochs=1)
SEED = 7  # step 0 draws MixUp, step 1 CutMix; TA draws rotate, shear, sharpness, ...
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def jax_shear3(monkeypatch):
    monkeypatch.setattr(jwarp, "affine_warp",
                        lambda im, op, mag: shear3_warp_pallas(im, op, mag, interpret=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(jdt, tdt):
    jm = JaxClassifier(backbone=JaxDarknet(**NARROW, dtype=jdt), num_classes=CLASSES, dtype=jdt)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    tx = jax_sgd(variables["params"], jax_schedule(**SCHEDULE), momentum=0.9, weight_decay=2e-5)
    jstate = JaxState.create(jm.apply, variables, tx)
    pm = ImageClassifier(Darknet(**NARROW, dtype=tdt, device="cpu"), CLASSES, dtype=tdt)
    pm.load_state_dict(flax_to_state_dict(_np(variables["params"]), _np(variables["batch_stats"])),
                       strict=True)
    opt = sgd_with_param_groups(pm, warmup_cosine_schedule(**SCHEDULE), momentum=0.9,
                                weight_decay=2e-5)
    return jstate, TrainState(pm, opt)


def _inputs():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, SHAPE).astype(np.uint8)
    return images, rng.integers(0, CLASSES, 8).astype(np.int32)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _flat(tensors: dict) -> np.ndarray:
    return np.concatenate([np.asarray(tensors[k], np.float32).ravel() for k in sorted(tensors)])


def _check(got: dict, want: dict, dtype: str, what: str, bound: float = 1e-2):
    """f32: every tensor at 1e-4; bf16: all tensors together at rel L2 ≤ bound."""
    assert sorted(got) == sorted(want), what
    if dtype == "float32":
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{what} {k}")
    else:
        err = _rel_l2(_flat(got), _flat(want))
        assert err <= bound, (what, err, bound)


def _port_state(state):
    params = {n: p.detach().numpy() for n, p in state.model.named_parameters()}
    stats = {n: b.numpy() for n, b in state.model.named_buffers()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    momentum = {names[id(p)]: b.numpy()
                for (_, ps), bs in zip(state.optimizer.groups, state.optimizer.buffers)
                for p, b in zip(ps, bs)}
    return params, stats, momentum


def _jax_state(state):
    as_np = lambda sd: {k: v.numpy() for k, v in sd.items()}
    return (as_np(flax_to_state_dict(_np(state.params))),
            as_np(flax_to_state_dict({}, _np(state.batch_stats))),
            as_np(flax_to_state_dict(_np(_trace(state.opt_state)))))


def _trace(opt_state):
    import optax

    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    return next(s for s in leaves if isinstance(s, optax.TraceState)).trace


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_full_recipe_steps_match_jax(jax_shear3, dtype, n_steps):
    jdt, tdt = DTYPES[dtype]
    jstate, tstate = _pair(jdt, tdt)
    images, labels = _inputs()
    jstep = jax.jit(jax_train_step(CLASSES, compute_dtype=jdt, **RECIPE))
    tstep = make_train_step(CLASSES, compute_dtype=tdt, **RECIPE)
    if dtype == "bfloat16":  # the JAX package's own f32 run, for its bf16 gradient error
        ref_state, _ = _pair(jnp.float32, torch.float32)
        ref_step = jax.jit(jax_train_step(CLASSES, compute_dtype=jnp.float32, **RECIPE))
    rng = jax.random.PRNGKey(SEED)
    for i in range(n_steps):
        draws = step_draws(rng, i, SHAPE, trivial_augment=True, random_erasing_p=0.5)
        assert draws.mix.use_cutmix == (i == 1)
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), rng)
        tm = tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels), draws=draws)
        _check({"loss": tm["loss"].numpy()}, {"loss": np.asarray(jm["loss"])}, dtype,
               f"loss at step {i}")
        if dtype == "bfloat16":
            ref_state, _ = ref_step(ref_state, jnp.asarray(images), jnp.asarray(labels), rng)
    assert tstate.step == int(jstate.step) == n_steps

    params, stats, momentum = _port_state(tstate)
    jparams, jstats, jmomentum = _jax_state(jstate)
    _check(params, jparams, dtype, "parameters")
    _check(stats, jstats, dtype, "BN statistics")
    if dtype == "float32":
        _check(momentum, jmomentum, dtype, "momentum")
    else:
        head = lambda d: {k: v for k, v in d.items() if k.startswith("head.")}
        _check(head(momentum), head(jmomentum), dtype, "head momentum")
        own_error = _rel_l2(_flat(jmomentum), _flat(_jax_state(ref_state)[2]))
        _check(momentum, jmomentum, dtype, "momentum", bound=own_error)


def test_eval_step_with_padded_labels_matches_jax():
    jstate, tstate = _pair(jnp.float32, torch.float32)
    images, labels = _inputs()
    labels[5:] = -1  # padding rows
    want = jax_eval_step()(jstate, jnp.asarray(images), jnp.asarray(labels))
    got = make_eval_step()(tstate, torch.from_numpy(images), torch.from_numpy(labels))
    for k in ("loss", "acc", "acc5", "count"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(got["count"]) == 5


def test_step_with_generator_is_seeded():
    """Same seed, same loss and parameters; the draws come only from the
    generator the step is given (the global seed changes nothing)."""
    images, labels = (torch.from_numpy(a) for a in _inputs())
    out = []
    for global_seed in (0, 1):
        torch.manual_seed(global_seed)
        _, state = _pair(jnp.float32, torch.float32)
        step = make_train_step(CLASSES, **RECIPE)
        g = torch.Generator().manual_seed(5)
        losses = [float(step(state, images, labels, g)["loss"]) for _ in range(2)]
        out.append((losses, state.model.head.weight.detach().clone()))
    assert out[0][0] == out[1][0] and torch.equal(out[0][1], out[1][1])
    assert out[0][0][0] != out[0][0][1]
    with pytest.raises(ValueError, match="Generator"):
        make_train_step(CLASSES, **RECIPE)(state, images, labels)
