"""The port's CaiT (vision_toolbox_tpu_torch/models/cait.py) vs the JAX CaiT.

A narrow CaiT (D = 192, 4 heads of width 48, 2 self-attention and 2
class-attention blocks, patch 16, 64 px: T = 16 patches) is initialised by
the JAX package and carried into the port through ``utils/jax_bridge.py``
with ``strict=True``. The JAX side is forced onto its kernels: the
talking-head kernel K5 in interpret mode (as
tests/test_cait_kernel_integration.py does) and the fused MLP half-block K3
(``_FORCE_ON``, as tests/test_torch_vit.py does); the port runs their plain
versions on CPU tensors. LayerScale γ is drawn around 0.1 so that the
attention branch shows in the output (at CaiT's 1e-6 it would vanish in
bf16).

Tolerances, as the ViT tests hold them:
- f32 forward: tests/torch_parity.py's rule with the tight share at 1e-3
  (K3 rounds its hidden activations to bf16 in an f32 model too, and a
  flip carries through the later blocks);
- bf16 forward: rel L2 ≤ 1e-2. Besides summation order, the class
  attention differs by one rounding: ``jax.nn.dot_product_attention``
  rounds its probabilities to bf16, the port keeps them f32
  (``ops/attention.py``); measured 7.6e-3;
- train steps: tests/test_torch_vit_train.py's (loss rel 1e-3 / 1e-2,
  every parameter and momentum buffer rel L2 ≤ 1e-2, or twice the JAX
  package's own bf16 error); two gradients that are zero in exact
  arithmetic, the key-projection biases and the pre-softmax mix bias (it
  shifts whole softmax rows), are summation noise on both sides and are
  held to ≤ 1e-3 of a neighbour's momentum instead.
"""

import numpy as np
import optax
import pytest
import torch
from torch_draws import step_draws
from torch_parity import assert_matches_kernel

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.block_mlp as jbm
import vision_toolbox_tpu.ops.cait_attention as jca
from vision_toolbox_tpu.models.cait import CaiT as JaxCaiT
from vision_toolbox_tpu.models.cait import cait_from_config as jax_cait_from_config
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import optim as joptim
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models import cait
from vision_toolbox_tpu_torch.models.cait import CaiT
from vision_toolbox_tpu_torch.ops import cait_attention as ca
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_train_step,
    optim,
    sgd_with_param_groups,
)
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

NARROW = dict(d_model=192, sa_depth=2, ca_depth=2, n_heads=4, patch_size=16, img_size=64,
              layer_scale_init=0.1)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CLASSES, SHAPE = 10, (4, 64, 64, 3)
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
LR = 0.1
SEED = 7  # step 0 draws MixUp, step 1 CutMix
LOSS_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
REL_L2 = 1e-2
ZERO_GRAD = 1e-3
NAMES = ("xxs_24", "xxs_36", "xs_24", "s_24", "s_36", "m_36", "m_48")


@pytest.fixture
def jax_kernels_on(monkeypatch):
    """The JAX CaiT through K5 (interpret mode) and K3 on the CPU."""
    talking_head = jca.talking_head_attention
    monkeypatch.setattr(jca, "use_talking_head_kernel", lambda *a: True)
    monkeypatch.setattr(jca, "talking_head_attention",
                        lambda *a, **kw: talking_head(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(jbm, "_FORCE_ON", True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _spread_gammas(params, seed=1):
    """Every LayerScale γ times 1 + U(0, 1): away from its constant init."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * (1.0 + rng.random(a.shape, dtype=np.float32))
        if getattr(path[-1], "key", "") == "gamma" else a, params)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cait_forward_matches_jax(jax_kernels_on, dtype):
    jdt, tdt = DTYPES[dtype]
    jm = JaxCaiT(**NARROW, dtype=jdt)
    params = _spread_gammas(jm.init_variables(0)["params"])
    pm = CaiT(**NARROW, dtype=tdt, device="cpu")
    pm.load_state_dict(flax_to_state_dict(_np(params)), strict=True)
    x = np.random.default_rng(1).random((3, 64, 64, 3), dtype=np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == tdt and got.shape == (3, 192)
    got = got.float().numpy()
    if dtype == "float32":
        assert_matches_kernel(got, want, tight=1e-3)
    else:
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_bridge_covers_every_parameter():
    """The bridged JAX tree loads strictly: sa_block_<i> → sa_blocks.<i>,
    ca_block_<i> → ca_blocks.<i>, the (H, H) mixes in their own layout."""
    params = _np(JaxCaiT(**NARROW).init_variables(0)["params"])
    sd = flax_to_state_dict(params)
    pm = CaiT(**NARROW, device="cpu")
    pm.load_state_dict(sd, strict=True)
    mix = params["sa_block_1"]["mha"]["proj_w_kernel"]
    assert np.array_equal(pm.sa_blocks[1].mha.proj_w_kernel.detach().numpy(), mix)
    assert not np.array_equal(mix, mix.T)


def _pair(dtype: str):
    jdt, tdt = DTYPES[dtype]
    jm = JaxClassifier(backbone=JaxCaiT(**NARROW, dtype=jdt), num_classes=CLASSES, dtype=jdt)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    params = _spread_gammas(variables["params"])
    jstate = JaxState.create(jm.apply, {"params": params},
                             jax_sgd(params, LR, momentum=0.9, weight_decay=2e-5))
    pm = ImageClassifier(CaiT(**NARROW, dtype=tdt, device="cpu"), CLASSES, dtype=tdt)
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


def _zero_gradient_ref(name: str) -> str | None:
    if name.endswith("k_proj.bias"):
        return name.replace("k_proj", "v_proj")
    if name.endswith("proj_l_bias"):
        return name.replace("proj_l_bias", "proj_l_kernel")
    return None


@pytest.mark.parametrize("dtype,n_steps", [("float32", 1), ("bfloat16", 2)])
def test_cait_train_steps_match_jax(jax_kernels_on, dtype, n_steps):
    losses, (params, momentum), (jparams, jmomentum) = _run(dtype, n_steps)
    for i, (got, want) in enumerate(losses):
        assert abs(got - want) <= LOSS_TOL[dtype] * abs(want), (i, got, want)
    assert sorted(params) == sorted(jparams) == sorted(momentum) == sorted(jmomentum)
    assert {n for n in params if n.split(".")[-1] in cait.MIX_PARAMS}  # the mixes are held too
    own = {}
    if dtype == "bfloat16":  # the JAX package's own bf16 error, against its f32 step
        _, _, ref = _run("float32", n_steps, port=False)
        own = {(what, k): _rel_l2(side[k], r[k])
               for what, side, r in (("param", jparams, ref[0]), ("momentum", jmomentum, ref[1]))
               for k in side}
    for what, got, want in (("param", params, jparams), ("momentum", momentum, jmomentum)):
        errs = {k: _rel_l2(got[k], want[k]) for k in want
                if not (what == "momentum" and _zero_gradient_ref(k))}
        bad = {k: (e, own.get((what, k))) for k, e in errs.items()
               if not e <= max(REL_L2, 2 * own.get((what, k), 0.0))}
        assert not bad, (what, bad)
    for k in filter(_zero_gradient_ref, momentum):  # zero gradients: held to a neighbour
        ref = np.linalg.norm(jmomentum[_zero_gradient_ref(k)])
        assert np.linalg.norm(momentum[k] - jmomentum[k]) <= ZERO_GRAD * ref, k


def test_param_groups_match_jax():
    """Every parameter of a CaiT classifier in the JAX package's group for
    the flax leaf the bridge maps onto it; ``proj_l_bias`` is no ``bias``
    leaf, so it is in 'other' (weight decay) on both sides."""
    from vision_toolbox_tpu_torch.utils.jax_bridge import _convert, _flatten

    jm = JaxClassifier(backbone=JaxCaiT(**NARROW), num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)["params"]
    jax_group = {_convert(path, v)[0]: joptim.param_group(path) for path, v in _flatten(params)}
    pm = ImageClassifier(CaiT(**NARROW, device="cpu"), CLASSES)
    pairs = {n: (optim.param_group(tuple(n.split("."))), jax_group[n])
             for n, _ in pm.named_parameters()}
    assert all(a == b for a, b in pairs.values()), {n: p for n, p in pairs.items() if p[0] != p[1]}
    assert pairs["backbone.sa_blocks.0.mha.proj_l_bias"] == ("other", "other")
    assert pairs["backbone.sa_blocks.0.mha.q_proj.bias"] == ("bias", "bias")


def test_registry_matches_jax_configs(monkeypatch):
    """All seven names are registered, each with the JAX package's widths,
    depths and heads (checked without building the large ones)."""
    assert [n for n in list_backbones() if n.startswith("cait_")] == sorted(
        f"cait_{v}" for v in NAMES)
    seen = {}
    monkeypatch.setattr(cait, "CaiT", lambda **kw: seen.setdefault("kw", kw))
    for v in NAMES:
        jm = jax_cait_from_config(v)
        kw = create_backbone(f"cait_{v}")
        assert (kw["d_model"], kw["sa_depth"], kw["ca_depth"], kw["n_heads"], kw["patch_size"]) \
            == (jm.d_model, jm.sa_depth, jm.ca_depth, jm.n_heads, jm.patch_size), v
        assert ca.use_talking_head_kernel(196, 196, kw["n_heads"], kw["d_model"] // kw["n_heads"])
        seen.clear()


def test_default_device_is_the_card():
    """With no ``device`` CaiT is built on the card; without a card the
    constructor raises instead of staying on the CPU."""
    if torch.cuda.is_available():
        assert next(create_backbone("cait_xxs_24").parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_backbone("cait_xxs_24")
    m = create_backbone("cait_xxs_24", img_size=32, device="cpu")
    assert len(m.sa_blocks) == 24 and len(m.ca_blocks) == 2 and m.last_out_channels == 192
    with torch.no_grad():
        assert m(torch.zeros(2, 32, 32, 3)).shape == (2, 192)


def test_serving_cast_keeps_the_mixes_f32():
    """``cast_for_serving`` stores every parameter but the LayerNorms' and
    the head mixes in bf16; the forward is bit-equal to the uncast model's."""
    kw = dict(NARROW, dtype=torch.bfloat16, device="cpu")
    m = CaiT(**kw, generator=torch.Generator().manual_seed(5))
    cast = CaiT(**kw, generator=torch.Generator().manual_seed(5)).cast_for_serving()
    kept = {n for n, p in cast.named_parameters() if p.dtype == torch.float32}
    assert kept == {n for n, _ in cast.named_parameters()
                    if "norm" in n or n.split(".")[-1] in cait.MIX_PARAMS}
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        assert torch.equal(m(x), cast(x))
        assert torch.equal(m(x), m(x, plain=True))  # CPU: the ops run their plain versions
