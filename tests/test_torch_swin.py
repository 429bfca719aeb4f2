"""The port's Swin (vision_toolbox_tpu_torch/models/swin.py) vs the JAX Swin.

Two narrow Swins are initialised by the JAX package (under one ``jax.jit``)
and carried into the port through ``utils/jax_bridge.py`` with
``strict=True``: 56 px, d_model 32, one 32-wide head, depths (2, 2), window
7 (stage 1's 14×14 grid shifts its second block, stage 2's 7×7 grid does
not), and 64 px with window 4 and two heads of 16, where both stages shift.
The JAX side runs its kernels in interpret mode: window attention K7
(``use_swin_kernel`` patched on), the shifted-window relayout K8
(``_FORCE_ON``) and the fused MLP half-block K3 (``_FORCE_ON``); the port
runs the plain versions of its kernels on CPU tensors. Its default dispatch
(the einsum path and ``jnp.roll``) is held in bf16 by rel L2, a standing
difference: the kernels keep the logits and the softmax in f32.

Tolerances, as the ConvNeXt and CaiT tests hold them:
- f32 forward: tests/torch_parity.py's rule with the tight share at 1e-3
  (K3 rounds its hidden activations to bf16 in an f32 model too);
- bf16 forward: rel L2 ≤ 1e-2 (summation order flips bf16 roundings);
- train steps: loss rel 1e-3 (f32) / 1e-2 (bf16), every parameter and
  momentum buffer rel L2 ≤ 1e-2, or twice the JAX package's own bf16 error
  against its f32 step where that is larger.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

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

import vision_toolbox_tpu.ops.block_mlp as jbm
import vision_toolbox_tpu.ops.swin_attention as jsa
import vision_toolbox_tpu.ops.swin_relayout as jsr
from vision_toolbox_tpu.models.swin import SwinTransformer as JaxSwin
from vision_toolbox_tpu.models.swin import resize_window_tables as jax_resize_window_tables
from vision_toolbox_tpu.models.swin import swin_from_config as jax_swin_from_config
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import optim as joptim
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models import swin
from vision_toolbox_tpu_torch.models.swin import SwinTransformer, resize_window_tables
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_train_step,
    optim,
    sgd_with_param_groups,
)
from vision_toolbox_tpu_torch.utils.export import export_model
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

NARROW = {  # name: (img_size, model kwargs)
    "w7": (56, dict(d_model=32, n_heads=1, depths=(2, 2), window_sizes=(7, 7))),
    "w4": (64, dict(d_model=32, n_heads=2, depths=(2, 2), window_sizes=(4, 4))),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CLASSES = 10
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
LR = 0.1
SEED = 7  # step 0 draws MixUp, step 1 CutMix
LOSS_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
REL_L2 = 1e-2
# a key-projection bias shifts each query's logits by one constant, which the
# softmax removes: its gradient is zero in exact arithmetic, so its momentum
# (rounding noise plus weight decay) is held against the value bias's
ZERO_GRAD = 1e-3
VARIANTS = ("t", "s", "b", "l", "s3-t", "s3-s", "s3-b")


@pytest.fixture
def jax_kernels_on(monkeypatch):
    """The JAX Swin's window attention, relayouts and MLP halves through
    their Pallas kernels (K7, K8, K3) on the CPU."""
    monkeypatch.setattr(jsa, "use_swin_kernel", lambda *a: True)
    monkeypatch.setattr(jsr, "_FORCE_ON", True)
    monkeypatch.setattr(jbm, "_FORCE_ON", True)


def _init(init, *args):
    """A flax init under one ``jax.jit``: run eagerly, it compiles every
    op of the model (the kernels in interpret mode included) on its own."""
    return jax.jit(lambda: init(*args))()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


@functools.lru_cache(maxsize=None)
def _params(name: str):
    """The JAX Swin's initial parameters (the same in every compute type)."""
    img, kw = NARROW[name]
    return _np(_init(JaxSwin(img_size=img, **kw).init_variables, 0, img)["params"])


def _forward_pair(name: str, dtype: str):
    img, kw = NARROW[name]
    jdt, tdt = DTYPES[dtype]
    jm = JaxSwin(img_size=img, **kw, dtype=jdt)
    params = _params(name)
    pm = SwinTransformer(img, **kw, dtype=tdt, device="cpu")
    pm.load_state_dict(flax_to_state_dict(params), strict=True)
    x = np.random.default_rng(1).random((2, img, img, 3), dtype=np.float32)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == tdt and got.shape == (2, 2 * kw["d_model"])
    return got.float().numpy(), np.asarray(want.astype(jnp.float32)), pm


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(NARROW))
def test_swin_forward_matches_jax_kernels(jax_kernels_on, name, dtype):
    got, want, pm = _forward_pair(name, dtype)
    shifted = [b.mha.shift for stage in pm.stages for b in stage]
    assert shifted == ([0, 3, 0, 0] if name == "w7" else [0, 2, 0, 2])
    if dtype == "float32":
        assert_matches_kernel(got, want, tight=1e-3)
    else:
        assert _rel_l2(got, want) <= REL_L2


def test_swin_forward_against_the_jax_default_dispatch():
    """The JAX package's default Swin (the einsum path with bf16 logits and
    softmax, ``jnp.roll``, its K3 off on the CPU) against the port's kernels'
    plain versions, bf16: a standing difference held by rel L2."""
    got, want, _ = _forward_pair("w4", "bfloat16")
    assert _rel_l2(got, want) <= REL_L2


def test_bridge_covers_every_parameter():
    """The bridged JAX tree loads strictly: stage_<i>_block_<j> →
    stages.<i>.<j>, downsample_<i>/reduction's (4C, 2C) kernel → (2C, 4C),
    relative_pe_table kept (1, N, (2w − 1)²)."""
    img, kw = NARROW["w4"]
    params = _params("w4")
    pm = SwinTransformer(img, **kw, device="cpu")
    pm.load_state_dict(flax_to_state_dict(params), strict=True)
    table = params["stage_1_block_1"]["mha"]["relative_pe_table"]
    assert table.shape == (1, 4, 49)
    assert np.array_equal(pm.stages[1][1].mha.relative_pe_table.detach().numpy(), table)
    kernel = params["downsample_1"]["reduction"]["kernel"]
    assert kernel.shape == (128, 64) and pm.downsample_1.reduction.bias is None
    assert np.array_equal(pm.downsample_1.reduction.weight.detach().numpy(), kernel.T)
    assert np.array_equal(pm.stages[0][1].mha.q_proj.weight.detach().numpy(),
                          params["stage_0_block_1"]["mha"]["q_proj"]["kernel"].T)


def _pair(dtype: str):
    jdt, tdt = DTYPES[dtype]
    img, kw = NARROW["w4"]
    jm = JaxClassifier(backbone=JaxSwin(img_size=img, **kw, dtype=jdt), num_classes=CLASSES,
                       dtype=jdt)
    variables = _init(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)),
                                      train=False))
    params = variables["params"]
    jstate = JaxState.create(jm.apply, {"params": params},
                             jax_sgd(params, LR, momentum=0.9, weight_decay=2e-5))
    pm = ImageClassifier(SwinTransformer(img, **kw, dtype=tdt, device="cpu"), CLASSES, dtype=tdt)
    pm.load_state_dict(flax_to_state_dict(_np(params)), strict=True)
    return jstate, TrainState(pm, sgd_with_param_groups(pm, LR, momentum=0.9, weight_decay=2e-5))


def _trace(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    return next(s for s in leaves if isinstance(s, optax.TraceState)).trace


def _run(dtype: str, n_steps: int, port: bool = True):
    """Both steps (or the JAX one alone); the losses and, per side,
    (parameters, momentum buffers) by port name."""
    jdt, tdt = DTYPES[dtype]
    img = NARROW["w4"][0]
    shape = (4, img, img, 3)
    jstate, tstate = _pair(dtype)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, shape).astype(np.uint8)
    labels = rng.integers(0, CLASSES, shape[0]).astype(np.int32)
    jstep = jax.jit(jax_train_step(CLASSES, compute_dtype=jdt, **RECIPE))
    tstep = make_train_step(CLASSES, compute_dtype=tdt, **RECIPE)
    key, losses = jax.random.PRNGKey(SEED), []
    for i in range(n_steps):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), key)
        tm = (tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels),
                    draws=step_draws(key, i, shape)) if port else {"loss": float("nan")})
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
def test_swin_train_steps_match_jax(jax_kernels_on, dtype, n_steps):
    losses, (params, momentum), (jparams, jmomentum) = _run(dtype, n_steps)
    for i, (got, want) in enumerate(losses):
        assert abs(got - want) <= LOSS_TOL[dtype] * abs(want), (i, got, want)
    assert sorted(params) == sorted(jparams) == sorted(momentum) == sorted(jmomentum)
    assert any(n.endswith("relative_pe_table") for n in params)  # dPE is held too
    errs = {(what, k): _rel_l2(got[k], want[k])
            for what, got, want in (("param", params, jparams), ("momentum", momentum, jmomentum))
            for k in want if not (what == "momentum" and k.endswith("k_proj.bias"))}
    own = {}
    if dtype == "bfloat16" and max(errs.values()) > REL_L2:
        # the JAX package's own bf16 error, against its f32 step, where REL_L2 is exceeded
        _, _, ref = _run("float32", n_steps, port=False)
        own = {(what, k): _rel_l2(side[k], r[k])
               for what, side, r in (("param", jparams, ref[0]), ("momentum", jmomentum, ref[1]))
               for k in side}
    bad = {k: (e, own.get(k)) for k, e in errs.items() if not e <= max(REL_L2, 2 * own.get(k, 0.0))}
    assert not bad, bad
    for k in (k for k in momentum if k.endswith("k_proj.bias")):
        ref = np.linalg.norm(jmomentum[k.replace("k_proj", "v_proj")])
        assert np.linalg.norm(momentum[k] - jmomentum[k]) <= ZERO_GRAD * ref, k


def test_param_groups_match_jax():
    """Every parameter of a Swin classifier in the JAX package's group for
    the flax leaf the bridge maps onto it: LayerNorms 'norm', biases
    'bias', the relative-PE tables 'other' (decayed)."""
    from vision_toolbox_tpu_torch.utils.jax_bridge import _convert, _flatten

    img, kw = NARROW["w4"]
    jm = JaxClassifier(backbone=JaxSwin(img_size=img, **kw), num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3))))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)["params"]
    jax_group = {_convert(path, v)[0]: joptim.param_group(path) for path, v in _flatten(params)}
    pm = ImageClassifier(SwinTransformer(img, **kw, device="cpu"), CLASSES)
    pairs = {n: (optim.param_group(tuple(n.split("."))), jax_group[n])
             for n, _ in pm.named_parameters()}
    assert all(a == b for a, b in pairs.values()), {n: p for n, p in pairs.items()
                                                    if p[0] != p[1]}
    assert pairs["backbone.stages.0.1.mha.relative_pe_table"] == ("other", "other")
    assert pairs["backbone.downsample_1.norm.bias"] == ("norm", "norm")
    assert pairs["backbone.patch_embed.bias"] == ("bias", "bias")


def test_registry_matches_jax_configs(monkeypatch):
    """All seven names are registered, each with the JAX package's width,
    heads, depths and windows (checked without building the large ones)."""
    assert [n for n in list_backbones() if n.startswith("swin")] == sorted(
        f"swin_{v}" for v in VARIANTS)
    seen = {}
    monkeypatch.setattr(swin, "SwinTransformer", lambda **kw: seen.setdefault("kw", kw))
    for v in VARIANTS:
        jm = jax_swin_from_config(v.upper())
        kw = create_backbone(f"swin_{v}")
        assert (kw["img_size"], kw["d_model"], kw["n_heads"], tuple(kw["depths"]),
                tuple(kw["window_sizes"])) == (jm.img_size, jm.d_model, jm.n_heads, jm.depths,
                                               jm.window_sizes), v
        seen.clear()


def test_default_device_is_the_card():
    """With no ``device`` Swin is built on the card; without a card the
    constructor raises instead of staying on the CPU."""
    if torch.cuda.is_available():
        assert next(create_backbone("swin_t").parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_backbone("swin_t")
    m = create_backbone("swin_t", device="cpu")
    assert [len(s) for s in m.stages] == [2, 2, 6, 2] and m.last_out_channels == 768
    assert [(i, j) for i, s in enumerate(m.stages) for j, b in enumerate(s) if b.mha.shift] == [
        (0, 1), (1, 1), (2, 1), (2, 3), (2, 5)]
    assert all(b.fused_at(t)  # the stages' tokens at 224 px
               for t, s in zip((3136, 784, 196, 49), m.stages) for b in s)


def test_exported_program_calls_the_kernels_ops():
    """The served program carries one ``vtt::swin_window_attention`` and one
    ``vtt::fused_mlp_block`` per block and one partition and unpartition per
    shifted block, no backward op, and computes the eager forward on CPU."""
    img, kw = NARROW["w4"]
    pm = SwinTransformer(img, **kw, dtype=torch.bfloat16, device="cpu")
    program = torch.export.load(io.BytesIO(export_model(pm, (2, img, img, 3))))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    count = lambda op: targets.count(f"vtt.{op}.default")
    assert count("swin_window_attention") == count("fused_mlp_block") == 4
    assert count("swin_window_partition") == count("swin_window_unpartition") == 2
    assert not [t for t in targets if "bwd" in t or "backward" in t]
    x = torch.rand(3, img, img, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(program.module()(x), pm(x))


def test_resize_window_tables_matches_jax():
    """Window 4 → 7 (and 7 → 4, shrinking) per stage: each block's table
    resized like the JAX package's ``resize_window_tables``
    (``jax.image.resize`` bicubic), to 1e-6; the resized state dict loads
    into a Swin built with the new windows."""
    img, kw = NARROW["w4"]
    params = _params("w4")
    for old, new in (((4, 4), (7, 4)), ((4, 4), (4, 2))):
        want = flax_to_state_dict(_np(jax_resize_window_tables(params, kw["depths"], old, new)))
        got = resize_window_tables(flax_to_state_dict(params), old, new)
        assert sorted(got) == sorted(want)
        for name in got:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        # 224 px: stage grids 56 and 28 take windows 7 and 4
        resized = SwinTransformer(224 if new[0] == 7 else img, **(kw | {"window_sizes": new}),
                                  device="cpu")
        resized.load_state_dict(got, strict=True)
