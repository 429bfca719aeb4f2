"""The port's MLP-Mixer (vision_toolbox_tpu_torch/models/mlp_mixer.py) vs the
JAX MLP-Mixer.

A narrow Mixer (2 blocks, d_model 64, patch 8, 32 px: N = 16 tokens, token
MLP 32 wide, channel MLP 256 wide) is initialised by the JAX package and
carried into the port through ``utils/jax_bridge.py`` with ``strict=True``.
Off a TPU the JAX Mixer runs its channel halves on the unfused chain unless
``block_mlp._FORCE_ON`` is set, while the port runs the fused op (K3's plain
version on CPU tensors) wherever the gate admits the shape: a standing
difference. So the parity checks run JAX with K3 forced on (interpret
mode), and the bf16 forward is also held against JAX's default dispatch.

Tolerances, as the ConvNeXt and ViT tests hold them:
- f32 forward: tests/torch_parity.py's rule with the tight share at 1e-3
  (K3 rounds its hidden activations to bf16 in an f32 model too);
- bf16 forward: rel L2 ≤ 1e-2, against JAX with K3 and with its default
  unfused chain;
- train steps: loss rel 1e-3 (f32) / 1e-2 (bf16), every parameter and
  momentum buffer rel L2 ≤ 1e-2, or twice the JAX package's own bf16 error
  against its f32 step where that is larger. One exception, rounding noise
  and not a fault: the token-mixing output bias. It adds one value to all d
  channels of a token, which every LayerNorm downstream removes (the next
  block's two and the final one; the residual stream ends in the final
  one), so its gradient is zero in exact arithmetic (JAX's unfused f32
  step: 1/470 and 1/270 of its K3 path's) and both packages return K3's bf16
  rounding noise there. Its distance is measured against the channel-mixing
  output bias's momentum (a sum of the same residual gradients, over tokens
  instead of channels), as chip_smoke.py holds the key-projection bias.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

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
from vision_toolbox_tpu.models.base import list_backbones as jax_list_backbones
from vision_toolbox_tpu.models.mlp_mixer import MLPMixer as JaxMixer
from vision_toolbox_tpu.models.mlp_mixer import mlp_mixer_from_config as jax_mixer_from_config
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import optim as joptim
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models import mlp_mixer
from vision_toolbox_tpu_torch.models.mlp_mixer import MLPMixer
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_train_step,
    optim,
    sgd_with_param_groups,
)
from vision_toolbox_tpu_torch.utils.export import export_model
from vision_toolbox_tpu_torch.utils.jax_bridge import _convert, flax_to_state_dict

NARROW = dict(n_layers=2, d_model=64, patch_size=8, img_size=32)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CLASSES, SHAPE = 10, (4, 32, 32, 3)
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
LR = 0.1
SEED = 7  # step 0 draws MixUp, step 1 CutMix
LOSS_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
REL_L2 = 1e-2
NAMES = ("mixer_b_16", "mixer_b_32", "mixer_l_16", "mixer_s_16", "mixer_s_32", "mixer_s_8")


@pytest.fixture
def jax_k3_on(monkeypatch):
    """The JAX Mixer's channel halves through K3 on the CPU."""
    monkeypatch.setattr(jbm, "_FORCE_ON", True)


def _init(init, *args):
    """A flax init under one ``jax.jit`` (eagerly every op compiles alone)."""
    return jax.jit(lambda: init(*args))()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(got, want, ref=None):
    """‖got − want‖ / ‖ref‖, ref defaulting to want."""
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    ref = want if ref is None else np.asarray(ref, np.float32).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(ref), 1e-12)


def _zero_gradient_ref(name: str) -> str | None:
    """The tensor a zero-in-exact-arithmetic gradient's distance is measured
    against (see the module docstring), else None."""
    if name.endswith("token_mixing.linear2.bias"):
        return name.replace("token_mixing", "channel_mixing")
    return None


_X = np.random.default_rng(1).random((2, 32, 32, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def jax_forwards():
    """One narrow JAX Mixer's parameters and its forwards, computed once:
    f32 and bf16 with K3 forced on, bf16 on its default (unfused) chain."""
    params = {}
    out = {}
    for dtype, (jdt, _) in DTYPES.items():
        jm = JaxMixer(**NARROW, dtype=jdt)
        params = params or _init(jm.init_variables, 0, 32)["params"]
        fwd = lambda p, x, jm=jm: jm.apply({"params": p}, x)
        jbm._FORCE_ON = True
        try:
            out[dtype, True] = np.asarray(jax.jit(fwd)(params, jnp.asarray(_X)).astype(jnp.float32))
        finally:
            jbm._FORCE_ON = False
        if dtype == "bfloat16":
            out[dtype, False] = np.asarray(jax.jit(fwd)(params, jnp.asarray(_X)).astype(
                jnp.float32))
    return _np(params), out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mixer_forward_matches_jax(jax_forwards, dtype):
    params, want = jax_forwards
    tdt = DTYPES[dtype][1]
    pm = MLPMixer(**NARROW, dtype=tdt, device="cpu")
    pm.load_state_dict(flax_to_state_dict(params), strict=True)
    assert all(b.fused_at(16) for b in pm.blocks)
    with torch.no_grad():
        got = pm(torch.from_numpy(_X))
    assert got.dtype == tdt and got.shape == (2, 64)
    got = got.float().numpy()
    if dtype == "float32":
        assert_matches_kernel(got, want[dtype, True], tight=1e-3)
    else:
        assert _rel_l2(got, want[dtype, True]) <= REL_L2
        assert _rel_l2(got, want[dtype, False]) <= REL_L2  # JAX's default dispatch on CPU
        with torch.no_grad():  # the port's chain against JAX's default chain
            chain = pm(torch.from_numpy(_X), force_unfused=True).float().numpy()
        assert _rel_l2(chain, want[dtype, False]) <= REL_L2


def _pair(dtype: str):
    jdt, tdt = DTYPES[dtype]
    jm = JaxClassifier(backbone=JaxMixer(**NARROW, dtype=jdt), num_classes=CLASSES, dtype=jdt)
    variables = _init(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                      train=False))
    params = variables["params"]
    jstate = JaxState.create(jm.apply, {"params": params},
                             jax_sgd(params, LR, momentum=0.9, weight_decay=2e-5))
    pm = ImageClassifier(MLPMixer(**NARROW, dtype=tdt, device="cpu"), CLASSES, dtype=tdt)
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
def test_mixer_train_steps_match_jax(jax_k3_on, dtype, n_steps):
    losses, (params, momentum), (jparams, jmomentum) = _run(dtype, n_steps)
    for i, (got, want) in enumerate(losses):
        assert abs(got - want) <= LOSS_TOL[dtype] * abs(want), (i, got, want)
    assert sorted(params) == sorted(jparams) == sorted(momentum) == sorted(jmomentum)
    own = {}
    if dtype == "bfloat16":  # the JAX package's own bf16 error, against its f32 step
        _, _, ref = _run("float32", n_steps, port=False)
        own = {(what, k): _rel_l2(side[k], r[k], r.get(_zero_gradient_ref(k)))
               for what, side, r in (("param", jparams, ref[0]), ("momentum", jmomentum, ref[1]))
               for k in side}
    for what, got, want in (("param", params, jparams), ("momentum", momentum, jmomentum)):
        errs = {k: _rel_l2(got[k], want[k], want.get(_zero_gradient_ref(k))) for k in want}
        bad = {k: (e, own.get((what, k))) for k, e in errs.items()
               if not e <= max(REL_L2, 2 * own.get((what, k), 0.0))}
        assert not bad, (what, bad)


def test_param_groups_match_jax():
    """Every parameter of a Mixer classifier in the JAX package's group for
    the flax leaf the bridge maps onto it (LayerNorms 'norm', biases 'bias',
    kernels 'other')."""
    jm = JaxClassifier(backbone=JaxMixer(**NARROW), num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    jax_group = {_convert(path, np.broadcast_to(np.float32(0), shape))[0]:
                 joptim.param_group(path) for path, shape in _shape_leaves(shapes["params"])}
    pm = ImageClassifier(MLPMixer(**NARROW, device="cpu"), CLASSES)
    pairs = {n: (optim.param_group(tuple(n.split("."))), jax_group[n])
             for n, _ in pm.named_parameters()}
    assert sorted(pairs) == sorted(jax_group)
    assert all(a == b for a, b in pairs.values()), {n: p for n, p in pairs.items()
                                                    if p[0] != p[1]}
    assert pairs["backbone.blocks.1.norm2.weight"] == ("norm", "norm")
    assert pairs["backbone.blocks.0.token_mixing.linear1.bias"] == ("bias", "bias")


def _shape_leaves(shapes):
    """(path, shape) of each leaf of a tree of ``ShapeDtypeStruct``s."""
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        yield tuple(k.key for k in path), s.shape


def _bridged_shapes(shapes) -> dict[str, tuple[int, ...]]:
    """Port name → shape of each leaf, through the bridge's rules (on
    zero-stride arrays: nothing allocated)."""
    return {key: tuple(value.shape) for key, value in (
        _convert(path, np.broadcast_to(np.float32(0), shape))
        for path, shape in _shape_leaves(shapes))}


def test_registry_and_full_size_shapes_match_jax():
    """The six names are JAX's ``mixer_*``, and every full-size parameter's
    bridged shape (``jax.eval_shape`` of the JAX init: no full-size init
    runs) equals the meta-device port model's."""
    assert [n for n in list_backbones() if n.startswith("mixer_")] == sorted(
        n for n in jax_list_backbones() if n.startswith("mixer_")) == sorted(NAMES)
    for name in NAMES:
        jm = jax_mixer_from_config(*{"s": "S", "b": "B", "l": "L"}[name[6]], int(name[8:]))
        shapes = jax.eval_shape(lambda jm=jm: jm.init_variables(0))["params"]
        want = _bridged_shapes(shapes)
        with torch.device("meta"):
            pm = create_backbone(name, device="meta")
        got = {n: tuple(p.shape) for n, p in pm.named_parameters()}
        assert got == want, name
        assert pm.last_out_channels == jm.last_out_channels == jm.d_model


def test_gate_is_the_jax_rule_for_every_name(monkeypatch):
    """Each name's channel half: the port's gate on N tokens (no residual,
    no LayerScale flags) answers as JAX's ``use_fused_mlp`` with its TPU
    test lifted; all six are admitted, mixer_s_8's N = 784 included."""
    monkeypatch.setattr(jbm, "_FORCE_ON", True)
    for name in NAMES:
        d = mlp_mixer.MIXER_VARIANTS[name[6].upper()][1]
        n = (224 // int(name[8:])) ** 2
        with torch.device("meta"):
            block = mlp_mixer.MixerBlock(n, d, generator=torch.Generator())
        assert block.fused_at(n) == jbm.use_fused_mlp(d, 4 * d, n, 0.0) is True, name
    assert not mlp_mixer.MixerBlock(16, 64, dropout=0.1, generator=torch.Generator()).fused_at(16)


def test_default_device_is_the_card():
    """With no ``device`` the Mixer is built on the card; without a card the
    constructor raises instead of staying on the CPU."""
    if torch.cuda.is_available():
        assert next(MLPMixer(**NARROW).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MLPMixer(**NARROW)


def test_exported_program_calls_the_kernels_ops():
    """The served program carries one ``vtt::fused_mlp_block`` per block and
    no backward op, and computes the eager forward on CPU."""
    pm = MLPMixer(**NARROW, dtype=torch.bfloat16, device="cpu")
    blob = export_model(pm, (2, 32, 32, 3))
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("vtt.fused_mlp_block.default") == NARROW["n_layers"]
    assert not [t for t in targets if "bwd" in t or "backward" in t]
    x = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(program.module()(x), pm(x))
