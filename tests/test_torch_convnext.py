"""The port's ConvNeXt (vision_toolbox_tpu_torch/models/convnext.py) vs the
JAX ConvNeXt.

A narrow v1 and v2 (d_model 32, depths (1, 1, 2, 1), 64 px: every stage
width a multiple of 32, so each v1 block runs the fused MLP half) are
initialised by the JAX package and carried into the port through
``utils/jax_bridge.py`` with ``strict=True``. The JAX side runs its fused MLP
half-block K3 (``_FORCE_ON``, interpret mode) and the port the plain
versions of its kernels on CPU tensors. The bf16 v1 forward also runs the
JAX depthwise conv K9 in interpret mode (``use_depthwise_kernel`` patched
on); everywhere else the JAX side keeps its default lax conv, which sums
the same f32 taps in another order: tracing K9 in interpret mode costs
about 80 s for a train step, and tests/test_torch_depthwise_conv.py holds
the twin to the kernel itself, forward and gradients, per shape.
LayerScale γ is drawn around 0.1 and GRN's γ and β around 0.5 so that both
branches show in the output (at their inits, 1e-6 and 0, they would vanish
or be the identity).

Tolerances, as the CaiT and ViT tests hold them:
- f32 forward: tests/torch_parity.py's rule with the tight share at 1e-3
  (K3 rounds its hidden activations to bf16 in an f32 model too);
- bf16 forward: rel L2 ≤ 1e-2 (summation order flips bf16 roundings);
- train steps: loss rel 1e-3 (f32) / 1e-2 (bf16), every parameter and
  momentum buffer rel L2 ≤ 1e-2, or twice the JAX package's own bf16 error
  against its f32 step where that is larger.
"""

import io

import numpy as np
import optax
import pytest
import torch
from torch_draws import step_draws
from torch_parity import assert_matches_kernel

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.block_mlp as jbm
import vision_toolbox_tpu.ops.depthwise_conv as jdc
from vision_toolbox_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from vision_toolbox_tpu.models.convnext import convnext_from_config as jax_convnext_from_config
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import optim as joptim
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models import convnext
from vision_toolbox_tpu_torch.models.convnext import ConvNeXt
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_train_step,
    optim,
    sgd_with_param_groups,
)
from vision_toolbox_tpu_torch.utils.export import export_model
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

NARROW = dict(d_model=32, depths=(1, 1, 2, 1))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CLASSES, SHAPE = 10, (4, 64, 64, 3)
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
LR = 0.1
SEED = 7  # step 0 draws MixUp, step 1 CutMix
LOSS_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
REL_L2 = 1e-2
VARIANTS = ("A", "F", "P", "N", "T", "S", "B", "L", "XL", "H")


@pytest.fixture
def jax_k3_on(monkeypatch):
    """The JAX ConvNeXt's MLP halves through K3 on the CPU."""
    monkeypatch.setattr(jbm, "_FORCE_ON", True)


def _init(init, *args):
    """A flax init under one ``jax.jit``: run eagerly, it compiles every
    op of the model (K3 in interpret mode included) on its own."""
    return jax.jit(lambda: init(*args))()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _spread(params, seed=1):
    """LayerScale γ times 1 + U(0, 1) around 0.1; GRN γ and β to U(0, 1)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        keys = [getattr(p, "key", "") for p in path]
        if keys[-1] == "gamma" and "layer_scale" in keys:
            return np.full(a.shape, 0.1, np.float32) * (1.0 + rng.random(a.shape, dtype=np.float32))
        if "grn" in keys:
            return rng.random(a.shape, dtype=np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_convnext_forward_matches_jax(jax_k3_on, monkeypatch, v2, dtype):
    jdt, tdt = DTYPES[dtype]
    jm = JaxConvNeXt(**NARROW, v2=v2, dtype=jdt)
    params = _spread(_init(jm.init_variables, 0, 64)["params"])
    if dtype == "bfloat16" and not v2:
        monkeypatch.setattr(jdc, "use_depthwise_kernel", lambda *a: True)
    pm = ConvNeXt(**NARROW, v2=v2, dtype=tdt, device="cpu")
    pm.load_state_dict(flax_to_state_dict(_np(params)), strict=True)
    assert all(b.fused_at(t) != v2  # the stages' tokens at 64 px
               for t, stage in zip((256, 64, 16, 4), pm.stages) for b in stage)
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == tdt and got.shape == (2, 256)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        assert_matches_kernel(got, want, tight=1e-3)
    else:
        assert _rel_l2(got, want) <= REL_L2


def test_bridge_covers_every_parameter():
    """The bridged JAX tree loads strictly: stage_<i>_block_<j> →
    stages.<i>.<j>, the (7, 7, 1, C) dwconv kernel → (C, 1, 7, 7)."""
    params = _np(_init(JaxConvNeXt(**NARROW, v2=True).init_variables, 0, 64)["params"])
    pm = ConvNeXt(**NARROW, v2=True, device="cpu")
    pm.load_state_dict(flax_to_state_dict(params), strict=True)
    kernel = params["stage_2_block_1"]["dwconv"]["kernel"]
    assert kernel.shape == (7, 7, 1, 128)
    got = pm.stages[2][1].dwconv.weight.detach().numpy()
    assert np.array_equal(got, kernel.transpose(3, 2, 0, 1))
    assert np.array_equal(pm.downsample_conv_3.weight.detach().numpy(),
                          params["downsample_conv_3"]["kernel"].transpose(3, 2, 0, 1))


def _pair(dtype: str):
    jdt, tdt = DTYPES[dtype]
    jm = JaxClassifier(backbone=JaxConvNeXt(**NARROW, dtype=jdt), num_classes=CLASSES, dtype=jdt)
    variables = _init(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                      train=False))
    params = _spread(variables["params"])
    jstate = JaxState.create(jm.apply, {"params": params},
                             jax_sgd(params, LR, momentum=0.9, weight_decay=2e-5))
    pm = ImageClassifier(ConvNeXt(**NARROW, dtype=tdt, device="cpu"), CLASSES, dtype=tdt)
    pm.load_state_dict(flax_to_state_dict(_np(params)), strict=True)
    return jstate, TrainState(pm, sgd_with_param_groups(pm, LR, momentum=0.9, weight_decay=2e-5))


def _trace(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    return next(s for s in leaves if isinstance(s, optax.TraceState)).trace


def _run(dtype: str, n_steps: int, port: bool = True):
    """Both steps (or the JAX one alone); the losses and, per side,
    (parameters, momentum buffers) by port name."""
    jdt, tdt = DTYPES[dtype]
    jstate, tstate = _pair(dtype)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, SHAPE).astype(np.uint8)
    labels = rng.integers(0, CLASSES, SHAPE[0]).astype(np.int32)
    jstep = jax.jit(jax_train_step(CLASSES, compute_dtype=jdt, **RECIPE))
    tstep = make_train_step(CLASSES, compute_dtype=tdt, **RECIPE)
    key, losses = jax.random.PRNGKey(SEED), []
    for i in range(n_steps):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), key)
        tm = (tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels),
                    draws=step_draws(key, i, SHAPE)) if port else {"loss": float("nan")})
        losses.append((float(tm["loss"]), float(jm["loss"])))
    as_np = lambda tree: {k: v.numpy() for k, v in flax_to_state_dict(_np(tree)).items()}
    jax_side = (as_np(jstate.params), as_np(_trace(jstate.opt_state)))
    if not port:
        return losses, None, jax_side
    names = {id(p): n for n, p in tstate.model.named_parameters()}
    momentum = {names[id(p)]: b.numpy() for (_, ps), bs in zip(tstate.optimizer.groups,
                                                               tstate.optimizer.buffers)
                for p, b in zip(ps, bs)}
    params = {n: p.detach().numpy() for n, p in tstate.model.named_parameters()}
    return losses, (params, momentum), jax_side


@pytest.mark.parametrize("dtype,n_steps", [("float32", 1), ("bfloat16", 2)])
def test_convnext_train_steps_match_jax(jax_k3_on, dtype, n_steps):
    losses, (params, momentum), (jparams, jmomentum) = _run(dtype, n_steps)
    for i, (got, want) in enumerate(losses):
        assert abs(got - want) <= LOSS_TOL[dtype] * abs(want), (i, got, want)
    assert sorted(params) == sorted(jparams) == sorted(momentum) == sorted(jmomentum)
    assert any(n.endswith("dwconv.weight") for n in params)  # the K9 weights are held too
    own = {}
    if dtype == "bfloat16":  # the JAX package's own bf16 error, against its f32 step
        _, _, ref = _run("float32", n_steps, port=False)
        own = {(what, k): _rel_l2(side[k], r[k])
               for what, side, r in (("param", jparams, ref[0]), ("momentum", jmomentum, ref[1]))
               for k in side}
    for what, got, want in (("param", params, jparams), ("momentum", momentum, jmomentum)):
        errs = {k: _rel_l2(got[k], want[k]) for k in want}
        bad = {k: (e, own.get((what, k))) for k, e in errs.items()
               if not e <= max(REL_L2, 2 * own.get((what, k), 0.0))}
        assert not bad, (what, bad)


def test_param_groups_match_jax():
    """Every parameter of a ConvNeXt v2 classifier in the JAX package's
    group for the flax leaf the bridge maps onto it (LayerNorms 'norm',
    biases 'bias', the dwconv kernel, LayerScale and GRN 'other')."""
    from vision_toolbox_tpu_torch.utils.jax_bridge import _convert, _flatten

    for v2 in (False, True):
        jm = JaxClassifier(backbone=JaxConvNeXt(**NARROW, v2=v2), num_classes=CLASSES)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
        params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)["params"]
        jax_group = {_convert(path, v)[0]: joptim.param_group(path)
                     for path, v in _flatten(params)}
        pm = ImageClassifier(ConvNeXt(**NARROW, v2=v2, device="cpu"), CLASSES)
        pairs = {n: (optim.param_group(tuple(n.split("."))), jax_group[n])
                 for n, _ in pm.named_parameters()}
        assert all(a == b for a, b in pairs.values()), {n: p for n, p in pairs.items()
                                                        if p[0] != p[1]}
    assert pairs["backbone.downsample_norm_1.bias"] == ("norm", "norm")
    assert pairs["backbone.stages.0.0.grn.beta"] == ("other", "other")


def test_registry_matches_jax_configs(monkeypatch):
    """All 20 names are registered, each with the JAX package's width,
    depths and version (checked without building the large ones)."""
    assert [n for n in list_backbones() if n.startswith("convnext")] == sorted(
        f"convnext{v}_{s.lower()}" for v in ("", "v2") for s in VARIANTS)
    seen = {}
    monkeypatch.setattr(convnext, "ConvNeXt", lambda **kw: seen.setdefault("kw", kw))
    for s in VARIANTS:
        for v2 in (False, True):
            jm = jax_convnext_from_config(s, v2=v2)
            kw = create_backbone(f"convnext{'v2' if v2 else ''}_{s.lower()}")
            assert (kw["d_model"], tuple(kw["depths"]), kw["v2"]) == (jm.d_model, jm.depths, v2)
            seen.clear()


def test_default_device_is_the_card():
    """With no ``device`` ConvNeXt is built on the card; without a card the
    constructor raises instead of staying on the CPU."""
    if torch.cuda.is_available():
        assert next(create_backbone("convnext_a").parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_backbone("convnext_a")
    m = create_backbone("convnext_a", device="cpu")
    assert [len(s) for s in m.stages] == [2, 2, 6, 2] and m.last_out_channels == 320
    assert [b.fused_at(t) for t, s in zip((64, 16, 4, 1), m.stages) for b in s][::2] == [
        False, False, True, True, True, True]  # the stages' tokens at 32 px
    with torch.no_grad():
        assert m(torch.zeros(1, 32, 32, 3)).shape == (1, 320)


def test_exported_program_calls_the_kernels_ops():
    """The served program carries one ``vtt::depthwise_conv2d`` and one
    ``vtt::fused_mlp_block`` per block (v1), no backward op, and computes
    the eager forward on CPU."""
    pm = ConvNeXt(**NARROW, dtype=torch.bfloat16, device="cpu")
    blob = export_model(pm, (2, 64, 64, 3))
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    n_blocks = sum(NARROW["depths"])
    assert targets.count("vtt.depthwise_conv2d.default") == n_blocks
    assert targets.count("vtt.fused_mlp_block.default") == n_blocks
    assert not [t for t in targets if "bwd" in t or "backward" in t]
    x = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(program.module()(x), pm(x))
