"""A SigLIP ViT at T = 1024 tokens in the port vs the JAX package.

A narrow SigLIP-style ViT that still has the 512 px model's token count: 128
px images, patch 4 (32 × 32 = 1024 tokens), D = 64, 2 heads of 32, depth 2,
no cls token and the MAP head, the shape of ``vit_b_16(img_size=512,
weights="siglip")`` cut in width and depth. Every block's attention core is
K6 on both sides: the JAX package's dispatch rule (``use_pallas``) is
patched to drop its TPU check only, so its blocks run the flash kernel in
interpret mode (block 256), and the port runs its plain versions on CPU
tensors; the MLP halves run K3 (the JAX kernel forced on, as
tests/test_torch_vit.py does). Nothing in the JAX package changes.

Tolerances are tests/test_torch_vit.py's and tests/test_torch_vit_train.py's:
the f32 forward rounds inside K3 to bf16 on both sides (a summation-order
flip moves an element by an ulp: tests/torch_parity.py's rule with 1e-3 as
the tight bound), bf16 forwards rel L2 ≤ 1e-2; train steps: loss rel 1e-3
(f32) or 1e-2 (bf16), every parameter and momentum buffer rel L2 ≤ 1e-2,
the key-bias gradient (zero in exact arithmetic) held to zero on each side,
and in bf16 a tensor may exceed 1e-2 by up to twice the JAX package's own
bf16 error for it.
"""

import functools
import io

import numpy as np
import optax
import pytest
import torch
from torch_draws import step_draws
from torch_parity import assert_matches_kernel

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.block_mlp as bm
import vision_toolbox_tpu.ops.flash_attention as jfa
from vision_toolbox_tpu.models.vit import ViT as JaxViT
from vision_toolbox_tpu.models.vit import resize_pe as jax_resize_pe
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu_torch.models.vit import ViT, resize_pe
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_train_step,
    sgd_with_param_groups,
)
from vision_toolbox_tpu_torch.utils.export import export_model, load_exported
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

NARROW = dict(d_model=64, depth=2, n_heads=2, patch_size=4, img_size=128, cls_token=False,
              pool_type="mha")
CLASSES, SHAPE = 10, (4, 128, 128, 3)
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
LR = 0.1
SEED = 7  # step 0 draws MixUp, step 1 CutMix
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOSS_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
REL_L2 = 1e-2
ZERO_GRAD = 1e-3  # key-bias gradient / value-bias gradient


@pytest.fixture
def jax_on_k6_k3(monkeypatch):
    """The JAX package's blocks on K6 (interpret mode) and K3, off a TPU."""
    monkeypatch.setattr(jfa, "use_pallas",
                        lambda seq_len: seq_len >= jfa.PALLAS_MIN_SEQ and seq_len % 128 == 0)
    monkeypatch.setattr(bm, "_FORCE_ON", True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_jax(jax_on_k6_k3, dtype):
    jdt, tdt = DTYPES[dtype]
    jm = JaxViT(**NARROW, dtype=jdt)
    variables = jm.init_variables(0)
    pm = ViT(**NARROW, dtype=tdt, device="cpu")
    pm.load_state_dict(flax_to_state_dict(_np(variables["params"])), strict=True)
    x = np.random.default_rng(1).random((2, 128, 128, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == tdt and got.shape == (2, 64)
    got = got.float().numpy()
    if dtype == "float32":
        assert_matches_kernel(got, want, tight=1e-3)
    else:
        assert _rel_l2(got, want) <= REL_L2


def _pair(dtype: str):
    jdt, tdt = DTYPES[dtype]
    jm = JaxClassifier(backbone=JaxViT(**NARROW, dtype=jdt), num_classes=CLASSES, dtype=jdt)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False)["params"]
    jstate = JaxState.create(jm.apply, {"params": params},
                             jax_sgd(params, LR, momentum=0.9, weight_decay=2e-5))
    pm = ImageClassifier(ViT(**NARROW, dtype=tdt, device="cpu"), CLASSES, dtype=tdt)
    pm.load_state_dict(flax_to_state_dict(_np(params)), strict=True)
    return jstate, TrainState(pm, sgd_with_param_groups(pm, LR, momentum=0.9, weight_decay=2e-5))


def _trace(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    return next(s for s in leaves if isinstance(s, optax.TraceState)).trace


def _port_momentum(state):
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: b.numpy() for (_, ps), bs in zip(state.optimizer.groups,
                                                           state.optimizer.buffers)
            for p, b in zip(ps, bs)}


@functools.cache
def _jax_step(dtype: str):
    """The jitted JAX step, compiled once per dtype for the whole file (only
    under ``jax_on_k6_k3``)."""
    return jax.jit(jax_train_step(CLASSES, compute_dtype=DTYPES[dtype][0], **RECIPE))


def _run(dtype: str, n_steps: int, port: bool = True):
    """Both steps (or the JAX one alone) for ``n_steps`` on the same uint8
    images, labels and draws; the losses and, per side, (parameters,
    momentum buffers) by port name."""
    tdt = DTYPES[dtype][1]
    jstate, tstate = _pair(dtype)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, SHAPE).astype(np.uint8)
    labels = rng.integers(0, CLASSES, SHAPE[0]).astype(np.int32)
    jstep = _jax_step(dtype)
    tstep = make_train_step(CLASSES, compute_dtype=tdt, **RECIPE)
    key = jax.random.PRNGKey(SEED)
    losses = []
    for i in range(n_steps):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), key)
        tm = (tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels),
                    draws=step_draws(key, i, SHAPE)) if port else {"loss": torch.tensor(0.0)})
        losses.append((float(tm["loss"]), float(jm["loss"])))
    as_np = lambda tree: {k: v.numpy() for k, v in flax_to_state_dict(_np(tree)).items()}
    jax_side = (as_np(jstate.params), as_np(_trace(jstate.opt_state)))
    if not port:
        return losses, None, jax_side
    port_side = ({n: p.detach().numpy() for n, p in tstate.model.named_parameters()},
                 _port_momentum(tstate))
    return losses, port_side, jax_side


@pytest.mark.parametrize("dtype,n_steps", [("float32", 1), ("float32", 2), ("bfloat16", 2)])
def test_train_steps_match_jax(jax_on_k6_k3, dtype, n_steps):
    """One and two steps of the transformer recipe, K6 forward and backward
    in every block on both sides (the JAX dK/dV and dQ kernels in interpret
    mode, the port's plain backward)."""
    losses, (params, momentum), (jparams, jmomentum) = _run(dtype, n_steps)
    for i, (got, want) in enumerate(losses):
        assert abs(got - want) <= LOSS_TOL[dtype] * abs(want), (i, got, want)
    assert sorted(params) == sorted(jparams) == sorted(momentum) == sorted(jmomentum)
    own = {}
    if dtype == "bfloat16":  # the JAX package's own bf16 error, against its f32 step
        _, _, ref = _run("float32", n_steps, port=False)
        own = {(what, k): _rel_l2(side[k], r[k])
               for what, side, r in (("param", jparams, ref[0]), ("momentum", jmomentum, ref[1]))
               for k in side}
    key_bias = lambda k: k.endswith("mha.k_proj.bias")  # the blocks' and the MAP head's
    for what, got, want in (("param", params, jparams), ("momentum", momentum, jmomentum)):
        errs = {k: _rel_l2(got[k], want[k]) for k in want
                if not (what == "momentum" and key_bias(k))}
        bad = {k: (e, own.get((what, k))) for k, e in errs.items()
               if not e <= max(REL_L2, 2 * own.get((what, k), 0.0))}
        assert not bad, (what, bad)
    for k in filter(key_bias, momentum):  # analytically zero, on both sides
        v = k.replace("k_proj", "v_proj")
        for side in (momentum, jmomentum):
            assert np.linalg.norm(side[k]) <= ZERO_GRAD * np.linalg.norm(side[v]), k


@pytest.mark.parametrize("old,new", [(14, 32), (32, 14), (14, 24)])
def test_resize_pe_matches_jax(old, new):
    """``resize_pe`` vs the JAX package's (``jax.image.resize``, bicubic,
    antialiased when shrinking) on a table at the init's scale, N(0, 0.02):
    the 224 px grid to 512 px and back, and to 384 px. 1e-6 absolute (the
    two sum the same f32 weights in another order)."""
    rng = np.random.default_rng(old + new)
    pe = (0.02 * rng.standard_normal((1, old * old, 96))).astype(np.float32)
    want = np.asarray(jax_resize_pe(jnp.asarray(pe), new * 16, 16))
    got = resize_pe(torch.from_numpy(pe), new * 16, 16)
    assert got.shape == (1, new * new, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_resize_pe_keeps_a_table_of_the_same_size():
    pe = torch.randn(1, 196, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(resize_pe(pe, 224, 16), pe)
    with pytest.raises(ValueError):
        resize_pe(pe, 512, 16, method="lanczos3")


def test_exported_program_calls_the_flash_op():
    """The served SigLIP program carries each block's attention as
    ``vtt::flash_attention`` and its MLP half as ``vtt::fused_mlp_block``,
    and no backward op; loaded, it answers as eager."""
    model = ViT(**NARROW, dtype=torch.bfloat16, device="cpu")
    blob = export_model(model, (2, 128, 128, 3))
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("vtt.flash_attention.default") == NARROW["depth"]
    assert targets.count("vtt.fused_mlp_block.default") == NARROW["depth"]
    assert not [t for t in targets if "bwd" in t or "backward" in t]
    x = torch.rand(3, 128, 128, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(load_exported(blob)(x), model(x))


def test_exported_program_feeds_the_flash_op_in_place():
    """Each block's q, k and v go from their projections to
    ``vtt::flash_attention`` through one reshape to (B, T, N, H) and nothing
    else, and its output to the output projection the same way: no permute,
    transpose or clone node around the op, which takes the layout the
    projections give (on the card its kernels read and write it in place)."""
    model = ViT(**NARROW, dtype=torch.bfloat16, device="cpu")
    program = torch.export.load(io.BytesIO(export_model(model, (2, 128, 128, 3))))
    target = lambda n: str(getattr(n, "target", ""))
    calls = [n for n in program.graph.nodes if target(n) == "vtt.flash_attention.default"]
    assert len(calls) == NARROW["depth"]
    for call in calls:
        for arg in call.args[:3]:
            assert target(arg) == "aten.reshape.default", target(arg)
            assert target(arg.args[0]) == "aten.linear.default", target(arg.args[0])
        (user,) = call.users
        assert target(user) == "aten.reshape.default", target(user)
        assert [target(u) for u in user.users] == ["aten.linear.default"]
        chain = [*call.args[:3], user]
        assert not [n for n in chain if any(w in target(n) for w in ("permute", "transpose",
                                                                       "clone"))]
