"""The port's ViT on the unfused block chain, whose attention runs the
short-attention kernel K2, vs the JAX ViT on CPU.

A narrow ViT (D = 128, 8 heads of 16, depth 2, patch 8, 32 px: T = 17 with
the cls token) at batch 8, so its attention has 64 (batch·head) pairs and
K2's rule admits it. The JAX side is forced onto K2 by patching
``vision_toolbox_tpu.ops.short_attention.use_short`` to drop its TPU test
(K2 then runs in interpret mode, its CPU default); its fused half-blocks
stay off, as they are on a CPU. The port runs K2's plain versions on CPU
tensors.

- Serving: both built with dropout 0.1 (the rate ViT-B/16 was trained with)
  in eval, so the fused kernels refuse both halves of every block. f32 is
  held to 1e-4 (summation order on the unfused f32 chain, as
  tests/test_torch_vit.py holds it), bf16 to rel L2 ≤ 1e-2 (the bound
  tests/test_torch_vit.py holds the bf16 ViT to).
- Training: one and two steps with dropout 0, the port's backbone called
  with ``force_unfused=True`` (the JAX package's chain under token
  sharding), with tests/test_torch_vit_train.py's recipe, draws and
  tolerances: loss rel 1e-3 (f32) / 1e-2 (bf16), every parameter and
  momentum buffer rel L2 ≤ 1e-2 or twice the JAX package's own bf16 error,
  the key-bias gradient (zero in exact arithmetic) ≤ 1e-3 of the value
  bias's on both sides.
- Export: the dropout-0.1 model's program answers at batch 1 (8 pairs: the
  JAX package's XLA attention) and batch 8 (K2) as the eager model does,
  each through the branch the JAX dispatch takes.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import functools
import io

import numpy as np
import optax
import pytest
import torch
from torch_draws import step_draws

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.short_attention as jsa
from vision_toolbox_tpu.models.vit import ViT as JaxViT
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import short_attention as sa
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_train_step,
    sgd_with_param_groups,
)
from vision_toolbox_tpu_torch.utils.export import export_model, load_exported
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

NARROW = dict(d_model=128, depth=2, n_heads=8, patch_size=8, img_size=32)
DROPOUT = 0.1
BATCH, CLASSES = 8, 10
SHAPE = (BATCH, 32, 32, 3)
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
LR = 0.1
SEED = 7  # step 0 draws MixUp, step 1 CutMix
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOSS_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
REL_L2 = 1e-2
ZERO_GRAD = 1e-3


@pytest.fixture
def k2_calls(monkeypatch):
    """The JAX dispatch forced onto K2 (its rule without the TPU test), and
    the K2 calls of both sides counted: JAX's ``short_attention_packed``
    and the port's plain forward."""
    calls = {"jax": 0, "port": 0}
    rule = lambda t, s, h, n: 2 <= t <= 512 and 2 <= s <= 512 and h <= 128 and n >= 64
    monkeypatch.setattr(jsa, "use_short", rule)
    jax_k2, port_k2 = jsa.short_attention_packed, sa.short_attention_plain

    def jax_spy(*a, **kw):
        calls["jax"] += 1
        return jax_k2(*a, **kw)

    def port_spy(*a):
        calls["port"] += 1
        return port_k2(*a)

    monkeypatch.setattr(jsa, "short_attention_packed", jax_spy)
    monkeypatch.setattr(sa, "short_attention_plain", port_spy)
    return calls


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _served_pair(dtype: str):
    jdt, tdt = DTYPES[dtype]
    jm = JaxViT(**NARROW, dropout=DROPOUT, dtype=jdt)
    variables = jm.init_variables(0)
    pm = ViT(**NARROW, dropout=DROPOUT, dtype=tdt, device="cpu")
    pm.load_state_dict(flax_to_state_dict(_np(variables["params"])), strict=True)
    pm.eval()
    x = np.random.default_rng(1).random(SHAPE, dtype=np.float32)
    return jm, variables, pm, x


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_served_dropout_vit_matches_jax_k2(k2_calls, dtype):
    jm, variables, pm, x = _served_pair(dtype)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    before = dict(_cuda.LAUNCHES)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == DTYPES[dtype][1] and _cuda.LAUNCHES == before
    assert k2_calls == {"jax": 2, "port": 2}  # one K2 call a block on each side
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert _rel_l2(got, want) <= REL_L2


def test_exported_dropout_vit_answers_at_both_branches(k2_calls, monkeypatch):
    """One program, traced at batch 8 with the batch free: at batch 8 each
    block's ``vtt::short_attention`` runs K2 (its plain version here), at
    batch 1 (8 pairs) ``dense_attention``, as eager does; both answers equal
    eager's."""
    dense_calls = []
    dense = sa.dense_attention
    monkeypatch.setattr(sa, "dense_attention", lambda *a: dense_calls.append(1) or dense(*a))
    _, _, pm, x = _served_pair("bfloat16")
    blob = export_model(pm, SHAPE)
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("vtt.short_attention.default") == 2
    served = load_exported(blob)
    images = torch.from_numpy(x)
    k2_calls["port"] = 0
    with torch.no_grad():
        for b, k2, dense_n in ((8, 2, 0), (1, 0, 2)):
            got = served(images[:b])
            assert (k2_calls["port"], len(dense_calls)) == (k2, dense_n), b
            want = pm(images[:b])
            assert torch.equal(got, want), b
            k2_calls["port"] = 0
            dense_calls.clear()


def _train_pair(dtype: str):
    jdt, tdt = DTYPES[dtype]
    jm = JaxClassifier(backbone=JaxViT(**NARROW, dtype=jdt), num_classes=CLASSES, dtype=jdt)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    params = variables["params"]
    jstate = JaxState.create(jm.apply, {"params": params},
                             jax_sgd(params, LR, momentum=0.9, weight_decay=2e-5))
    backbone = ViT(**NARROW, dtype=tdt, device="cpu")
    backbone.forward = functools.partial(ViT.forward, backbone, force_unfused=True)
    pm = ImageClassifier(backbone, CLASSES, dtype=tdt)
    pm.load_state_dict(flax_to_state_dict(_np(params)), strict=True)
    return jstate, TrainState(pm, sgd_with_param_groups(pm, LR, momentum=0.9,
                                                        weight_decay=2e-5))


def _trace(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    return next(s for s in leaves if isinstance(s, optax.TraceState)).trace


def _port_momentum(state):
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: b.numpy() for (_, ps), bs in zip(state.optimizer.groups,
                                                           state.optimizer.buffers)
            for p, b in zip(ps, bs)}


def _run(dtype: str, n_steps: int, port: bool = True):
    """Both steps (or the JAX one alone) for ``n_steps`` from one state and
    one set of draws; the losses and, per side, (parameters, momentum)."""
    jdt, tdt = DTYPES[dtype]
    jstate, tstate = _train_pair(dtype)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, SHAPE).astype(np.uint8)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    jstep = jax.jit(jax_train_step(CLASSES, compute_dtype=jdt, **RECIPE))
    tstep = make_train_step(CLASSES, compute_dtype=tdt, **RECIPE)
    key = jax.random.PRNGKey(SEED)
    losses = []
    for i in range(n_steps):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), key)
        tm = (tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels),
                    draws=step_draws(key, i, SHAPE)) if port else {"loss": float("nan")})
        losses.append((float(tm["loss"]), float(jm["loss"])))
    as_np = lambda tree: {k: v.numpy() for k, v in flax_to_state_dict(_np(tree)).items()}
    jax_side = (as_np(jstate.params), as_np(_trace(jstate.opt_state)))
    if not port:
        return losses, None, jax_side
    return losses, ({n: p.detach().numpy() for n, p in tstate.model.named_parameters()},
                    _port_momentum(tstate)), jax_side


@pytest.mark.parametrize("dtype,n_steps", [("float32", 1), ("bfloat16", 2)])
def test_unfused_train_steps_match_jax_k2(k2_calls, dtype, n_steps):
    losses, (params, momentum), (jparams, jmomentum) = _run(dtype, n_steps)
    assert k2_calls["port"] == 2 * n_steps and k2_calls["jax"] >= 2  # JAX traces once
    for i, (got, want) in enumerate(losses):
        assert abs(got - want) <= LOSS_TOL[dtype] * abs(want), (i, got, want)
    own = {}
    if dtype == "bfloat16":  # the JAX package's own bf16 error, against its f32 step
        _, _, ref = _run("float32", n_steps, port=False)
        own = {(what, k): _rel_l2(side[k], r[k])
               for what, side, r in (("param", jparams, ref[0]), ("momentum", jmomentum, ref[1]))
               for k in side}
    key_bias = lambda k: k.endswith("mha.k_proj.bias")
    for what, got, want in (("param", params, jparams), ("momentum", momentum, jmomentum)):
        assert sorted(got) == sorted(want)
        errs = {k: _rel_l2(got[k], want[k]) for k in want
                if not (what == "momentum" and key_bias(k))}
        bad = {k: (e, own.get((what, k))) for k, e in errs.items()
               if not e <= max(REL_L2, 2 * own.get((what, k), 0.0))}
        assert not bad, (what, bad)
    for k in filter(key_bias, momentum):  # zero in exact arithmetic, on both sides
        v = k.replace("k_proj", "v_proj")
        for side in (momentum, jmomentum):
            assert np.linalg.norm(side[k]) <= ZERO_GRAD * np.linalg.norm(side[v]), k
