"""The port's VoVNet (vision_toolbox_tpu_torch/models/vovnet.py) vs the JAX
VoVNet.

A narrow VoVNet with eSE (stem 16; stages (1 block, mid 8, 2 layers, out 16)
and (1, 8, 2, 24): the first block keeps 16 channels, so its residual
runs, the second does not), 32 px, is initialised by the JAX package and
carried into the port through ``utils/jax_bridge.py`` with ``strict=True``,
BN statistics included (perturbed away from their init so eval mode reads
them). No TPU kernel runs in the model; its max pools follow ReLUs, so
their windows tie often (all-zero windows), and the gradient at a tie must
land on the same tap as XLA's: the input and parameter gradients are held
in train mode on such maps.

Tolerances: f32 forward and gradients rtol = atol = 1e-5 / 1e-4 (f32
summation order of the convolutions and the batch statistics); bf16 feature
maps rel L2 ≤ 1e-2 (in train mode, or twice the JAX package's own bf16
error where that is larger: its batch statistics over a few values a
channel), and the running statistics together rel L2 ≤ 1e-2. Train steps (CutMix⊕MixUp, label smoothing 0.1, SGD 0.9 with
three-group weight decay): f32 loss, parameters, momentum buffers and BN
statistics rtol = atol = 1e-4; bf16 loss rel L2 ≤ 1e-2, and parameters and
BN statistics taken together rel L2 ≤ 1e-2, each momentum buffer rel L2 ≤
1e-2 or within twice the JAX package's own bf16 error for that buffer
against its f32 step (the BN backward cancels in bf16, as
tests/test_torch_train_step.py sets out).
"""

import io

import numpy as np
import optax
import pytest
import torch
from torch_draws import step_draws

import jax
import jax.numpy as jnp

from vision_toolbox_tpu.models.base import list_backbones as jax_list_backbones
from vision_toolbox_tpu.models.vovnet import VoVNet as JaxVoVNet
from vision_toolbox_tpu.models.vovnet import vovnet_from_config as jax_vovnet_from_config
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import optim as joptim
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models import vovnet
from vision_toolbox_tpu_torch.models.vovnet import VoVNet
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_train_step,
    optim,
    sgd_with_param_groups,
)
from vision_toolbox_tpu_torch.utils.export import export_model
from vision_toolbox_tpu_torch.utils.jax_bridge import _convert, flax_to_state_dict

NARROW = dict(stem_channels=16, stage_configs=((1, 8, 2, 16), (1, 8, 2, 24)), ese=True)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CLASSES, SHAPE = 10, (8, 32, 32, 3)
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
LR = 0.1
SEED = 7  # step 0 draws MixUp, step 1 CutMix
TOL = 1e-5
REL_L2 = 1e-2
NAMES = ("vovnet19_ese", "vovnet19_slim_ese", "vovnet27_slim", "vovnet39", "vovnet39_ese",
         "vovnet57", "vovnet57_ese", "vovnet99_ese")


def _init(init, *args):
    """A flax init under one ``jax.jit`` (eagerly every op compiles alone)."""
    return jax.jit(lambda: init(*args))()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _variables(seed=1):
    """The narrow JAX VoVNet's variables, BN statistics and scales moved
    off their init."""
    variables = _np(_init(JaxVoVNet(**NARROW).init_variables, 0, 32))
    rng = np.random.default_rng(seed)

    def f(path, a):
        leaf = getattr(path[-1], "key", "")
        if leaf in ("mean", "bias"):
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if leaf in ("var", "scale"):
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, variables)


_X = np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32)


def _port(variables, dtype=None):
    pm = VoVNet(**NARROW, dtype=dtype, device="cpu")
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]),
                       strict=True)
    return pm


@pytest.fixture(scope="module")
def jax_feature_maps():
    """The JAX feature maps of ``_variables()`` per (dtype, train), each
    forward jitted once, with the running statistics a train-mode call
    leaves."""
    variables, out = _variables(), {}
    for dtype, (jdt, _) in DTYPES.items():
        jm = JaxVoVNet(**NARROW, dtype=jdt)
        for train in (False, True):
            fmaps = jax.jit(lambda v, x, jm=jm, train=train: jm.apply(
                v, x, train, method="get_feature_maps", mutable=["batch_stats"] if train else False))
            got = fmaps(variables, jnp.asarray(_X))
            maps, stats = got if train else (got, None)
            out[dtype, train] = ([np.asarray(m.astype(jnp.float32)) for m in maps],
                                 stats and _np(stats["batch_stats"]))
    return variables, out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vovnet_feature_maps_match_jax(jax_feature_maps, dtype):
    """Every feature map (stem and stages), eval and train mode, and the
    running statistics a train-mode call leaves. In bf16 an eval-mode map
    (the served forward) lies within rel L2 1e-2 of JAX's; a train-mode map
    may lie up to twice the JAX package's own bf16 error from JAX's: at 2
    images the last stage normalises 32 values a channel, which amplifies
    bf16 rounding flips in both packages (measured 2.1e-2 from jitted JAX,
    which lies 2.6e-2 from its f32 forward, as the port does)."""
    variables, want_all = jax_feature_maps
    tdt = DTYPES[dtype][1]
    pm = _port(variables, tdt)
    assert (pm.out_channels_list, pm.stride) == ((16, 16, 24), 8)
    for train in (False, True):
        want, stats = want_all[dtype, train]
        with torch.no_grad():
            got = pm.get_feature_maps(torch.from_numpy(_X), train=train)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == tdt
            g = g.float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
            elif not train:
                assert _rel_l2(g, w) <= REL_L2, i
            else:
                own = _rel_l2(w, want_all["float32", train][0][i])
                assert _rel_l2(g, w) <= max(REL_L2, 2 * own), (i, own)
    stats = {k: v.numpy() for k, v in flax_to_state_dict({}, stats).items()}
    got = {k: v.numpy() for k, v in pm.state_dict().items() if k in stats}
    if dtype == "float32":
        for k in stats:
            np.testing.assert_allclose(got[k], stats[k], rtol=1e-4, atol=1e-5, err_msg=k)
    else:
        assert _rel_l2(_flat(got), _flat(stats)) <= REL_L2


def test_vovnet_gradients_at_pool_ties_match_jax():
    """f32, train mode: the input and every parameter gradient of
    ⟨last map, cotangent⟩ against ``jax.grad``; the stem's ReLU output (the
    first pool's input) has all-zero 3 × 3 windows, whose gradient goes to
    one tap on both sides (the stem's last BN shifted to a bias of -1.5,
    so that most of its outputs are zero)."""
    variables = _variables()
    variables["params"]["stem_2"]["norm"]["bias"][:] = -1.5  # mostly zeros after the ReLU
    jm = JaxVoVNet(**NARROW)
    ct = np.random.default_rng(3).standard_normal((2, 4, 4, 24)).astype(np.float32)

    def f(params, x):
        maps, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, True,
                           method="get_feature_maps", mutable=["batch_stats"])
        return jnp.sum(maps[-1] * ct), maps[0]

    grad = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    (_, stem), (jgrads, jdx) = grad(variables["params"], jnp.asarray(_X))
    stem = np.asarray(stem)
    windows = np.lib.stride_tricks.sliding_window_view(stem[:, :15, :15], (3, 3), axis=(1, 2))
    assert (windows[:, ::2, ::2].max(axis=(-1, -2)) == 0).mean() > 0.1  # tied windows
    pm = _port(variables)
    x = torch.from_numpy(_X).requires_grad_()
    out = pm.get_feature_maps(x, train=True)[-1]
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-4)
    want = {k: v.numpy() for k, v in flax_to_state_dict(_np(jgrads)).items()}
    got = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def _pair(dtype: str):
    jdt, tdt = DTYPES[dtype]
    jm = JaxClassifier(backbone=JaxVoVNet(**NARROW, dtype=jdt), num_classes=CLASSES, dtype=jdt)
    variables = _np(_init(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                          train=False)))
    jstate = JaxState.create(jm.apply, variables,
                             jax_sgd(variables["params"], LR, momentum=0.9, weight_decay=2e-5))
    pm = ImageClassifier(VoVNet(**NARROW, dtype=tdt, device="cpu"), CLASSES, dtype=tdt)
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]),
                       strict=True)
    return jstate, TrainState(pm, sgd_with_param_groups(pm, LR, momentum=0.9, weight_decay=2e-5))


def _trace(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    return next(s for s in leaves if isinstance(s, optax.TraceState)).trace


def _flat(tensors: dict) -> np.ndarray:
    return np.concatenate([np.asarray(tensors[k], np.float32).ravel() for k in sorted(tensors)])


def _run(dtype: str, n_steps: int, port: bool = True):
    """Both steps (or the JAX one alone): the losses, and after each step
    per side (parameters, BN statistics, momentum buffers), copied."""
    jdt, tdt = DTYPES[dtype]
    jstate, tstate = _pair(dtype)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, SHAPE).astype(np.uint8)
    labels = rng.integers(0, CLASSES, SHAPE[0]).astype(np.int32)
    jstep = jax.jit(jax_train_step(CLASSES, compute_dtype=jdt, **RECIPE))
    tstep = make_train_step(CLASSES, compute_dtype=tdt, **RECIPE)
    key, losses, states = jax.random.PRNGKey(SEED), [], []
    names = {id(p): n for n, p in tstate.model.named_parameters()}
    as_np = lambda sd: {k: v.numpy() for k, v in sd.items()}
    for i in range(n_steps):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), key)
        tm = (tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels),
                    draws=step_draws(key, i, SHAPE)) if port else {"loss": float("nan")})
        losses.append((float(tm["loss"]), float(jm["loss"])))
        jax_side = (as_np(flax_to_state_dict(_np(jstate.params))),
                    as_np(flax_to_state_dict({}, _np(jstate.batch_stats))),
                    as_np(flax_to_state_dict(_np(_trace(jstate.opt_state)))))
        port_side = port and (
            {n: p.detach().numpy().copy() for n, p in tstate.model.named_parameters()},
            {n: b.numpy().copy() for n, b in tstate.model.named_buffers()},
            {names[id(p)]: b.numpy().copy() for (_, ps), bs in zip(tstate.optimizer.groups,
                                                                   tstate.optimizer.buffers)
             for p, b in zip(ps, bs)})
        states.append((port_side, jax_side))
    return losses, states


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vovnet_train_steps_match_jax(dtype):
    """Two steps; loss, parameters, BN statistics and momentum buffers after
    each."""
    losses, states = _run(dtype, 2)
    kinds = ("parameters", "BN statistics", "momentum")
    refs = [None, None]
    if dtype == "bfloat16":  # the JAX package's own bf16 error, against its f32 steps
        refs = [jax_side for _, jax_side in _run("float32", 2, port=False)[1]]
    for step, ((port, jax_side), ref) in enumerate(zip(states, refs)):
        for got, want, what in zip(port, jax_side, kinds):
            assert sorted(got) == sorted(want), what
        if dtype == "float32":
            np.testing.assert_allclose(*losses[step], rtol=1e-4, atol=1e-4)
            for got, want, what in zip(port, jax_side, kinds):
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                               err_msg=f"step {step} {what} {k}")
            continue
        assert _rel_l2(*losses[step]) <= REL_L2
        for got, want, what in zip(port[:2], jax_side[:2], kinds):
            assert _rel_l2(_flat(got), _flat(want)) <= REL_L2, (step, what)
        bad = {}
        for k, want in jax_side[2].items():  # each momentum buffer (gradient) on its own
            e, own = _rel_l2(port[2][k], want), _rel_l2(want, ref[2][k])
            if not e <= max(REL_L2, 2 * own):
                bad[k] = (e, own)
        assert not bad, (step, bad)


def _shape_leaves(shapes):
    """(path, shape) of each leaf of a tree of ``ShapeDtypeStruct``s."""
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        yield tuple(k.key for k in path), s.shape


def test_param_groups_match_jax():
    """Every parameter of a VoVNet classifier in the JAX package's group for
    the flax leaf the bridge maps onto it (BN 'norm', the eSE conv's bias
    'bias', kernels 'other')."""
    jm = JaxClassifier(backbone=JaxVoVNet(**NARROW), num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    jax_group = {_convert(path, np.broadcast_to(np.float32(0), shape))[0]:
                 joptim.param_group(path) for path, shape in _shape_leaves(shapes["params"])}
    pm = ImageClassifier(VoVNet(**NARROW, device="cpu"), CLASSES)
    pairs = {n: (optim.param_group(tuple(n.split("."))), jax_group[n])
             for n, _ in pm.named_parameters()}
    assert sorted(pairs) == sorted(jax_group)
    assert all(a == b for a, b in pairs.values()), {n: p for n, p in pairs.items()
                                                    if p[0] != p[1]}
    assert pairs["backbone.stages.0.0.ese.linear.bias"] == ("bias", "bias")
    assert pairs["backbone.stages.1.0.out_conv.norm.weight"] == ("norm", "norm")


def test_registry_and_full_size_shapes_match_jax():
    """The eight names are JAX's ``vovnet*``, and every full-size parameter's
    and BN statistic's bridged shape, from ``jax.eval_shape`` of the JAX
    init, equals the meta-device port model's."""
    assert [n for n in list_backbones() if n.startswith("vovnet")] == sorted(
        n for n in jax_list_backbones() if n.startswith("vovnet")) == sorted(NAMES)
    for name in NAMES:
        variant = int(name[6:8])
        jm = jax_vovnet_from_config(variant, slim="slim" in name, ese="ese" in name)
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
        assert (pm.out_channels_list, pm.stride) == (jm.out_channels_list, jm.stride)


def test_default_device_is_the_card():
    """With no ``device`` VoVNet is built on the card; without a card the
    constructor raises instead of staying on the CPU."""
    if torch.cuda.is_available():
        assert next(VoVNet(**NARROW).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            VoVNet(**NARROW)
    assert vovnet.vovnet_from_config(57, device="cpu").stage_configs == (
        (1, 128, 5, 256), (1, 160, 5, 512), (4, 192, 5, 768), (3, 224, 5, 1024))


def test_exported_program_equals_eager():
    """The served program (no custom op: no kernel runs in the model) holds
    no backward op and computes the eager forward on CPU."""
    pm = _port(_variables(), torch.bfloat16)
    pm.eval()
    blob = export_model(pm, (2, 32, 32, 3))
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert not [t for t in targets if t.startswith("vtt.") or "bwd" in t or "backward" in t]
    x = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(program.module()(x), pm(x))
