"""The port's PatchConvNet (vision_toolbox_tpu_torch/models/patchconvnet.py)
vs the JAX PatchConvNet.

A narrow PatchConvNet (embed_dim 32, depth 2, 64 px: a 4 × 4 map after the
stride-16 stem, SE 8 wide), BatchNorm and LayerNorm trunks, is initialised
by the JAX package and carried into the port through
``utils/jax_bridge.py`` with ``strict=True``; LayerScale γs (1e-6 at init,
which would round every branch away) are drawn around 0.1. The JAX side
keeps its default lax depthwise conv and the port runs K9's plain version
on CPU tensors: the same f32 taps summed in another order. One bf16 forward
runs JAX's K9 in interpret mode (``use_depthwise_kernel`` patched on):
tracing it for a train step costs about 80 s, and
tests/test_torch_depthwise_conv.py holds the plain version to the kernel,
forward and gradients, at k = 3.

Drop-path is 0.3 in every block and twice in the pooling head, so training
draws 2 + 2 masks a step. The same keep masks are fed to both sides in the
JAX package's order (blocks, then the head's two) by patching
``jax.random.bernoulli`` for the keep probability and the port's
``StochasticDepth.sample_scale``.

Tolerances: f32 forward rtol = atol = 1e-5; bf16 forward rel L2 ≤ 1e-2;
train steps: loss rel 1e-3 (f32) / 1e-2 (bf16), every parameter, momentum
buffer and BN statistic rel L2 ≤ 1e-2; in bf16, where that is larger, up to
twice the JAX package's own bf16 error against its f32 step, from the JAX
bf16 step or from that f32 step. At batch 4 on a 4 × 4 map some bf16
gradients (the SE biases, BN scales) are noise-dominated in both packages:
two independent bf16 roundings of one f32 computation differ by about √2
times either's error, so the port may lie past 2× from the JAX bf16 step
while as close to the f32 step as JAX's own. The pooling head's
key-projection bias, whose gradient is zero in exact arithmetic, is
measured against the value bias's tensor.
"""

import io

import numpy as np
import optax
import pytest
import torch
from torch_draws import step_draws

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.depthwise_conv as jdc
from vision_toolbox_tpu.models.base import list_backbones as jax_list_backbones
from vision_toolbox_tpu.models.patchconvnet import PatchConvNet as JaxPatchConvNet
from vision_toolbox_tpu.models.patchconvnet import patchconvnet_from_config as jax_from_config
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import optim as joptim
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models.patchconvnet import PatchConvNet
from vision_toolbox_tpu_torch.nn.layers import StochasticDepth
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_train_step,
    optim,
    sgd_with_param_groups,
)
from vision_toolbox_tpu_torch.utils.export import export_model
from vision_toolbox_tpu_torch.utils.jax_bridge import _convert, flax_to_state_dict

NARROW = dict(embed_dim=32, depth=2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CLASSES, SHAPE = 10, (4, 64, 64, 3)
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
LR = 0.1
SEED = 7  # step 0 draws MixUp, step 1 CutMix
DROP = 0.3
KEEP = 1.0 - DROP  # as the JAX module computes it
LOSS_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
REL_L2 = 1e-2
TOL = 1e-5


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
    """The pooling head's key-projection bias has a zero gradient in exact
    arithmetic (it shifts the class token's logits by a constant, which the
    softmax removes): its distance is measured against the value bias's
    tensor, as chip_smoke.py and tests/test_torch_vit_train.py hold it."""
    return name.replace("k_proj", "v_proj") if name.endswith("k_proj.bias") else None


def _spread(params, seed=1):
    """Every LayerScale γ times 1 + U(0, 1) around 0.1; BN and LN scales
    and biases spread too, so that the statistics' paths show."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        leaf = getattr(path[-1], "key", "")
        if leaf.startswith("layer_scale"):
            return np.full(a.shape, 0.1, np.float32) * (1.0 + rng.random(a.shape, dtype=np.float32))
        if leaf in ("scale", "bias") and "norm" in getattr(path[-2], "key", ""):
            return (0.5 if leaf == "scale" else 0.0) + rng.random(a.shape, dtype=np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


def _stats(variables):
    return _np(variables.get("batch_stats", {}))


class _Masks:
    """Drop-path keep masks from a numpy seed, one set per step in the JAX
    package's draw order, handed to ``jax.random.bernoulli`` (calls at the
    keep probability; the others, CutMix's coin, pass through) and to the
    port's ``StochasticDepth.sample_scale``. A jitted JAX step draws once
    when it is traced; the port draws every step: both take mask i mod n."""

    def __init__(self, monkeypatch, batch: int, per_step: int, seed: int = 11):
        rng = np.random.default_rng(seed)
        self.masks = [rng.random(batch) < KEEP for _ in range(per_step)]
        self.jax_calls = self.port_calls = 0
        bernoulli = jax.random.bernoulli

        def jax_draw(key, p=0.5, shape=None):
            if p != KEEP:
                return bernoulli(key, p, shape)
            mask = self.masks[self.jax_calls % len(self.masks)]
            self.jax_calls += 1
            return jnp.asarray(mask.reshape(shape))

        def port_draw(sd, batch, train=False, generator=None, *, device=None):
            if not train or sd.p == 0.0:
                return None
            assert sd.p == DROP
            mask = self.masks[self.port_calls % len(self.masks)]
            self.port_calls += 1
            return (torch.from_numpy(mask).reshape(batch, 1).float() / KEEP).to(device)

        monkeypatch.setattr(jax.random, "bernoulli", jax_draw)
        monkeypatch.setattr(StochasticDepth, "sample_scale", port_draw)


_X = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def jax_forwards():
    """Per trunk, the spread JAX parameters and statistics, and the JAX
    forwards computed once: f32 and bf16 on the lax conv, and (BN) bf16
    with JAX's K9 in interpret mode."""
    out = {}
    for norm in ("bn", "ln"):
        jm = JaxPatchConvNet(**NARROW, norm_type=norm)
        variables = _init(jm.init_variables, 0, 64)
        params, stats = _spread(_np(variables["params"])), _stats(variables)
        out[norm, "vars"] = (params, stats)
        for dtype, (jdt, _) in DTYPES.items():
            jm = JaxPatchConvNet(**NARROW, norm_type=norm, dtype=jdt)
            fwd = jax.jit(lambda p, s, x, jm=jm: jm.apply({"params": p, "batch_stats": s}, x))
            out[norm, dtype, "lax"] = np.asarray(fwd(params, stats, jnp.asarray(_X)).astype(
                jnp.float32))
            if norm == "bn" and dtype == "bfloat16":
                original = jdc.use_depthwise_kernel
                jdc.use_depthwise_kernel = lambda *a: True
                try:
                    fwd = jax.jit(lambda p, s, x, jm=jm: jm.apply({"params": p, "batch_stats": s},
                                                                  x))
                    out[norm, dtype, "k9"] = np.asarray(fwd(params, stats, jnp.asarray(_X)).astype(
                        jnp.float32))
                finally:
                    jdc.use_depthwise_kernel = original
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("norm", ["bn", "ln"])
def test_patchconvnet_forward_matches_jax(jax_forwards, norm, dtype):
    params, stats = jax_forwards[norm, "vars"]
    tdt = DTYPES[dtype][1]
    pm = PatchConvNet(**NARROW, norm_type=norm, dtype=tdt, device="cpu")
    pm.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(_X))
    assert got.dtype == tdt and got.shape == (2, 32)
    assert pm.get_feature_maps(torch.from_numpy(_X))[0].shape == (2, 32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, jax_forwards[norm, dtype, "lax"], rtol=TOL, atol=TOL)
    else:
        assert _rel_l2(got, jax_forwards[norm, dtype, "lax"]) <= REL_L2
        if norm == "bn":  # JAX's K9 kernel in interpret mode
            assert _rel_l2(got, jax_forwards[norm, dtype, "k9"]) <= REL_L2


def _pair(dtype: str, norm: str):
    jdt, tdt = DTYPES[dtype]
    jm = JaxClassifier(backbone=JaxPatchConvNet(**NARROW, norm_type=norm, dtype=jdt),
                       num_classes=CLASSES, dtype=jdt)
    variables = _init(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                      train=False))
    params = _spread(_np(variables["params"]))
    stats = _stats(variables)
    jstate = JaxState.create(jm.apply, {"params": params, "batch_stats": stats},
                             jax_sgd(params, LR, momentum=0.9, weight_decay=2e-5))
    pm = ImageClassifier(PatchConvNet(**NARROW, norm_type=norm, dtype=tdt, device="cpu"),
                         CLASSES, dtype=tdt)
    pm.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    return jstate, TrainState(pm, sgd_with_param_groups(pm, LR, momentum=0.9, weight_decay=2e-5))


def _trace(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    return next(s for s in leaves if isinstance(s, optax.TraceState)).trace


def _jax_side(jstate):
    as_np = lambda tree, stats=None: {
        k: v.numpy() for k, v in flax_to_state_dict(_np(tree), stats).items()}
    stats = {k: v.numpy() for k, v in flax_to_state_dict({}, _np(jstate.batch_stats)).items()}
    return as_np(jstate.params), as_np(_trace(jstate.opt_state)), stats


def _port_side(tstate):
    """Copies: the optimizer updates the tensors in place."""
    names = {id(p): n for n, p in tstate.model.named_parameters()}
    momentum = {names[id(p)]: b.numpy().copy() for (_, ps), bs in zip(tstate.optimizer.groups,
                                                                      tstate.optimizer.buffers)
                for p, b in zip(ps, bs)}
    params = {n: p.detach().numpy().copy() for n, p in tstate.model.named_parameters()}
    stats = {n: b.numpy().copy() for n, b in tstate.model.named_buffers()}
    return params, momentum, stats


def _run(dtype: str, norm: str, n_steps: int, port: bool = True):
    """Both steps (or the JAX one alone); the losses and, after each step,
    per side (parameters, momentum buffers, BN statistics) by port name."""
    jdt, tdt = DTYPES[dtype]
    jstate, tstate = _pair(dtype, norm)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, SHAPE).astype(np.uint8)
    labels = rng.integers(0, CLASSES, SHAPE[0]).astype(np.int32)
    jstep = jax.jit(jax_train_step(CLASSES, compute_dtype=jdt, **RECIPE))
    tstep = make_train_step(CLASSES, compute_dtype=tdt, **RECIPE)
    key, losses, states = jax.random.PRNGKey(SEED), [], []
    for i in range(n_steps):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), key)
        tm = (tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels),
                    draws=step_draws(key, i, SHAPE)) if port else {"loss": float("nan")})
        losses.append((float(tm["loss"]), float(jm["loss"])))
        states.append((_port_side(tstate) if port else None, _jax_side(jstate)))
    return losses, states


@pytest.mark.parametrize("dtype,norm,n_steps", [("float32", "bn", 2), ("bfloat16", "bn", 2),
                                                ("float32", "ln", 1)])
def test_patchconvnet_train_steps_match_jax(monkeypatch, dtype, norm, n_steps):
    """Loss, parameters, momentum buffers and (BN) running statistics after
    each step, drop-path 0.3 with the same masks on both sides."""
    masks = _Masks(monkeypatch, SHAPE[0], NARROW["depth"] + 2)
    losses, states = _run(dtype, norm, n_steps)
    assert masks.port_calls == len(masks.masks) * n_steps
    assert masks.jax_calls == len(masks.masks)  # drawn when the jitted step is traced
    for i, (got, want) in enumerate(losses):
        assert abs(got - want) <= LOSS_TOL[dtype] * abs(want), (i, got, want)
    refs = [None] * n_steps
    if dtype == "bfloat16":  # the JAX package's own bf16 error, against its f32 step
        refs = [jax_side for _, jax_side in _run("float32", norm, n_steps, port=False)[1]]
    kinds = ("param", "momentum", "BN statistic")
    for step, ((port, jax_side), ref) in enumerate(zip(states, refs)):
        assert [sorted(d) for d in port] == [sorted(d) for d in jax_side]
        assert bool(port[2]) == (norm == "bn")
        for what, got, want, r in zip(kinds, port, jax_side, ref or (None,) * 3):
            bad = {}
            for k in want:
                v = _zero_gradient_ref(k)
                e = _rel_l2(got[k], want[k], want.get(v))
                if r is None:
                    if not e <= REL_L2:
                        bad[k] = e
                    continue
                own = _rel_l2(want[k], r[k], r.get(v))
                to_f32 = _rel_l2(got[k], r[k], r.get(v))
                if not min(e, to_f32) <= max(REL_L2, 2 * own):
                    bad[k] = (e, to_f32, own)
            assert not bad, (step, what, bad)


def test_param_groups_match_jax():
    """Every parameter of a PatchConvNet classifier (BN and LN trunks) in the
    JAX package's group for the flax leaf the bridge maps onto it: norms
    'norm', biases (SE's too) 'bias', kernels, ``layer_scale*`` and
    ``cls_token`` 'other'."""
    for norm in ("bn", "ln"):
        jm = JaxClassifier(backbone=JaxPatchConvNet(**NARROW, norm_type=norm),
                           num_classes=CLASSES)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
        jax_group = {_convert(path, np.broadcast_to(np.float32(0), shape))[0]:
                     joptim.param_group(path) for path, shape in _shape_leaves(shapes["params"])}
        pm = ImageClassifier(PatchConvNet(**NARROW, norm_type=norm, device="cpu"), CLASSES)
        pairs = {n: (optim.param_group(tuple(n.split("."))), jax_group[n])
                 for n, _ in pm.named_parameters()}
        assert sorted(pairs) == sorted(jax_group)
        assert all(a == b for a, b in pairs.values()), {n: p for n, p in pairs.items()
                                                        if p[0] != p[1]}
    assert pairs["backbone.blocks.0.layer_scale"] == ("other", "other")
    assert pairs["backbone.pool.cls_token"] == ("other", "other")
    assert pairs["backbone.blocks.1.se.fc2.bias"] == ("bias", "bias")
    assert pairs["backbone.pool.norm3.bias"] == ("norm", "norm")


def _shape_leaves(shapes):
    """(path, shape) of each leaf of a tree of ``ShapeDtypeStruct``s."""
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        yield tuple(k.key for k in path), s.shape


def test_registry_and_full_size_shapes_match_jax():
    """The three names are JAX's ``patchconvnet_*``, and every full-size
    (depth 60) parameter's and BN statistic's bridged shape, from
    ``jax.eval_shape`` of the JAX init, equals the meta-device port
    model's."""
    names = [n for n in list_backbones() if n.startswith("patchconvnet_")]
    assert names == sorted(n for n in jax_list_backbones() if n.startswith("patchconvnet_")) == [
        "patchconvnet_b", "patchconvnet_l", "patchconvnet_s"]
    for name in names:
        jm = jax_from_config(name[-1].upper())
        shapes = jax.eval_shape(lambda jm=jm: jm.init_variables(0, 64))
        want = {}
        for kind in ("params", "batch_stats"):
            for path, shape in _shape_leaves(shapes[kind]):
                key, value = _convert(path, np.broadcast_to(np.float32(0), shape))
                want[key] = tuple(value.shape)
        with torch.device("meta"):
            pm = create_backbone(name, device="meta")
        got = {n: tuple(t.shape) for n, t in pm.state_dict().items()}
        assert got == want, name
        assert len(pm.blocks) == jm.depth == 60
        assert (pm.out_channels_list, pm.stride) == (jm.out_channels_list, jm.stride)


def test_default_device_is_the_card():
    """With no ``device`` PatchConvNet is built on the card; without a card
    the constructor raises instead of staying on the CPU."""
    if torch.cuda.is_available():
        assert next(PatchConvNet(**NARROW).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PatchConvNet(**NARROW)


def test_exported_program_calls_the_kernels_ops():
    """The served program carries one ``vtt::depthwise_conv2d`` per block and
    no backward op, and computes the eager forward on CPU."""
    pm = PatchConvNet(**NARROW, dtype=torch.bfloat16, device="cpu")
    blob = export_model(pm, (2, 64, 64, 3))
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("vtt.depthwise_conv2d.default") == NARROW["depth"]
    assert not [t for t in targets if "bwd" in t or "backward" in t]
    x = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(program.module()(x), pm(x))
