"""The port's ViT train step vs the JAX package's: one and two steps of a
narrow ViT (D = 128, depth 2, 4 heads, patch 8, 32 px, so T = 17 with the
cls token) with an ImageClassifier head of 10 classes, batch 8, uint8
images; label smoothing 0.1, CutMix⊕MixUp (1.0 / 0.2), SGD momentum 0.9 with
weight decay 2e-5 in three groups. The production recipe of the JAX
package's transformer step (scripts/measure_block_kernels.py), cut to size.

Both sides run every block through the fused half-blocks and train through
their backward: the JAX kernels in interpret mode with the fused path forced
on (``_FORCE_ON``, as tests/test_torch_vit.py does), the port's plain
save-forward and plain backward on CPU tensors. Same variables (bridged),
same draws (tests/torch_draws.py). LayerScale blocks in some cases, so the
γ_ls branch of both backward kernels is held too.

Tolerances: loss rel 1e-3 (f32) or 1e-2 (bf16 compute); every parameter and
every momentum buffer rel L2 ≤ 1e-2 per tensor. Both sides round at the same
points; the f32 sums run in another order (tests/torch_parity.py). Two
exceptions, both rounding noise and not faults (ROADMAP Queue 3):

- the key-projection bias: its gradient is zero in exact arithmetic (adding
  one vector to every key shifts each query's logits by a constant, which
  the softmax removes), so both packages return summation noise there
  (~1e-6 of the value-bias gradient in f32). Each side's key-bias gradient
  is held to ≤ 1e-3 of its value-bias gradient, i.e. to zero;
- in bf16, the query/key projection gradients (the softmax backward cancels
  in dp − rowsum(dp·p), and ds is rounded to bf16) are as far from the JAX
  package's as the JAX package's own bf16 gradients are from its f32 ones
  (measured 1.2–3.1e-2 against 1.2–2.3e-2). Two independent bf16 roundings
  of one f32 computation differ by about √2 times either's error, so a
  tensor may exceed 1e-2 by up to twice the JAX package's own bf16 error
  for it.
"""

import numpy as np
import optax
import pytest
import torch
from torch_draws import step_draws

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.block_attention as ba
import vision_toolbox_tpu.ops.block_mlp as bm
from vision_toolbox_tpu.models.vit import ViT as JaxViT
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_train_step,
    sgd_with_param_groups,
)
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

NARROW = dict(d_model=128, depth=2, n_heads=4, patch_size=8, img_size=32)
CLASSES, SHAPE = 10, (8, 32, 32, 3)
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
LR = 0.1
SEED = 7  # step 0 draws MixUp, step 1 CutMix
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOSS_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
REL_L2 = 1e-2
ZERO_GRAD = 1e-3  # key-bias gradient / value-bias gradient


@pytest.fixture
def jax_fused_on(monkeypatch):
    monkeypatch.setattr(ba, "_FORCE_ON", True)
    monkeypatch.setattr(bm, "_FORCE_ON", True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(dtype: str, layer_scale: float | None):
    jdt, tdt = DTYPES[dtype]
    kw = {**NARROW, "layer_scale_init": layer_scale}
    jm = JaxClassifier(backbone=JaxViT(**kw, dtype=jdt), num_classes=CLASSES, dtype=jdt)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    params = variables["params"]
    if layer_scale is not None:  # γ away from its constant init, so dγ_ls matters
        rng = np.random.default_rng(1)
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: a * (1.0 + rng.random(a.shape, dtype=np.float32))
            if getattr(path[-1], "key", "") == "gamma" else a, params)
    jstate = JaxState.create(jm.apply, {"params": params},
                             jax_sgd(params, LR, momentum=0.9, weight_decay=2e-5))
    pm = ImageClassifier(ViT(**kw, dtype=tdt, device="cpu"), CLASSES, dtype=tdt)
    pm.load_state_dict(flax_to_state_dict(_np(params)), strict=True)
    opt = sgd_with_param_groups(pm, LR, momentum=0.9, weight_decay=2e-5)
    return jstate, TrainState(pm, opt)


def _inputs():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, SHAPE).astype(np.uint8)
    return images, rng.integers(0, CLASSES, 8).astype(np.int32)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _trace(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    return next(s for s in leaves if isinstance(s, optax.TraceState)).trace


def _port_momentum(state):
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: b.numpy() for (_, ps), bs in zip(state.optimizer.groups,
                                                           state.optimizer.buffers)
            for p, b in zip(ps, bs)}


def _run(dtype: str, n_steps: int, layer_scale: float | None, port: bool = True):
    """Both steps (or the JAX one alone) for ``n_steps``; returns the losses
    and, per side, (parameters, momentum buffers) by port name."""
    jdt, tdt = DTYPES[dtype]
    jstate, tstate = _pair(dtype, layer_scale)
    images, labels = _inputs()
    jstep = jax.jit(jax_train_step(CLASSES, compute_dtype=jdt, **RECIPE))
    tstep = make_train_step(CLASSES, compute_dtype=tdt, **RECIPE)
    rng = jax.random.PRNGKey(SEED)
    losses = []
    for i in range(n_steps):
        draws = step_draws(rng, i, SHAPE)
        assert draws.mix.use_cutmix == (i == 1)
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), rng)
        tm = (tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels), draws=draws)
              if port else {"loss": torch.tensor(float("nan"))})
        losses.append((float(tm["loss"]), float(jm["loss"])))
    as_np = lambda tree: {k: v.numpy() for k, v in flax_to_state_dict(_np(tree)).items()}
    jax_side = (as_np(jstate.params), as_np(_trace(jstate.opt_state)))
    if not port:
        return losses, None, jax_side
    assert tstate.step == int(jstate.step) == n_steps
    port_side = ({n: p.detach().numpy() for n, p in tstate.model.named_parameters()},
                 _port_momentum(tstate))
    return losses, port_side, jax_side


def _key_bias(name: str) -> bool:
    return name.endswith("mha.k_proj.bias")


@pytest.mark.parametrize("dtype,n_steps,layer_scale", [
    ("float32", 1, None), ("float32", 2, 0.1), ("bfloat16", 1, 0.1), ("bfloat16", 2, None),
])
def test_vit_train_steps_match_jax(jax_fused_on, dtype, n_steps, layer_scale):
    losses, (params, momentum), (jparams, jmomentum) = _run(dtype, n_steps, layer_scale)
    for i, (got, want) in enumerate(losses):
        assert abs(got - want) <= LOSS_TOL[dtype] * abs(want), (i, got, want)
    assert all(p.dtype == np.float32 for p in params.values())  # f32 master weights
    assert sorted(params) == sorted(jparams) == sorted(momentum) == sorted(jmomentum)
    own = {}
    if dtype == "bfloat16":  # the JAX package's own bf16 error, against its f32 step
        _, _, ref = _run("float32", n_steps, layer_scale, port=False)
        own = {(what, k): _rel_l2(side[k], r[k])
               for what, side, r in (("param", jparams, ref[0]), ("momentum", jmomentum, ref[1]))
               for k in side}

    for what, got, want in (("param", params, jparams), ("momentum", momentum, jmomentum)):
        errs = {k: _rel_l2(got[k], want[k]) for k in want
                if not (what == "momentum" and _key_bias(k))}
        bad = {k: (e, own.get((what, k))) for k, e in errs.items()
               if not e <= max(REL_L2, 2 * own.get((what, k), 0.0))}
        assert not bad, (what, bad)
    for k in filter(_key_bias, momentum):  # analytically zero, on both sides
        v = k.replace("k_proj", "v_proj")
        for side in (momentum, jmomentum):
            assert np.linalg.norm(side[k]) <= ZERO_GRAD * np.linalg.norm(side[v]), k
