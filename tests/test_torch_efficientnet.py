"""The port's MBConv, EfficientNet and MobileNetV3
(vision_toolbox_tpu_torch/models/mbconv.py, efficientnet.py, mobilenet.py)
vs the JAX modules.

Variables are drawn with numpy on the JAX init's shapes and carried into
the port through ``utils/jax_bridge.py`` with ``strict=True``
(tests/torch_convnets.py). On the CPU the port's stride-1 depthwise convs
run K9's plain version, where the JAX package's default dispatch runs the
lax conv: the same f32 taps summed in another order. One bf16 MBConv
forward runs JAX's K9 in interpret mode (``use_depthwise_kernel`` patched
on), the kernel the port's K9 is the counterpart of;
tests/test_torch_depthwise_conv.py holds the plain version to that kernel,
forward and gradients, at k = 3, 5 and 7.

- ``MBConv`` in both semantics (MobileNetV3: relu, SE relu/hard sigmoid,
  hardswish; EfficientNet: SiLU, SE SiLU/sigmoid), the stride-1 block with
  its residual and a stride-2 one: eval and train outputs, running
  statistics, input and parameter gradients.
- A narrow EfficientNet (width ×0.25, depth ×0.5: ten blocks, residuals in
  four) and a short MobileNetV3 (four blocks, SE and hardswish, strides 1
  and 2): every feature tap, eval and train, f32 and bf16; the gradients of
  every tap; train steps with drop-path 0.2·i/10 (the same keep masks on
  both sides).
- ``out_channels_list`` of all 10 names, the registry, the bridged
  full-size shapes of efficientnet_b0 and mobilenet_v3_large, the default
  device, and the exported program (one ``vtt::depthwise_conv2d`` per
  stride-1 block).

Tolerances: f32 rtol = atol = 1e-5 for a block, 5e-4 for a whole model in
train mode (a chain of train-mode BNs whose fast variance cancels), 1e-5
in eval mode; gradients 1e-4 after dividing by max(1, max|JAX|); bf16 maps
rel L2 ≤ 1e-2, or within twice the JAX package's own bf16 error against
its f32 forward where that is larger (its SiLU rounds twice, F.silu once;
at these narrow widths a tap's own error reaches 2e-2 in eval mode); the bf16 MBConv
against JAX's K9 by tests/torch_parity.py's rule (≥ 75% of elements within
1e-4, all within 1e-2: the same rounding points, sums in another order);
train steps as tests/torch_convnets.py sets out.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import io

import numpy as np
import pytest
import torch
from torch_convnets import (
    DTYPES, REL_L2, TOL, DropPathMasks, check_steps, hold_module, load, rel_l2, run_steps,
    variables_for,
)
from torch_parity import assert_matches_kernel

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.depthwise_conv as jdc
from vision_toolbox_tpu.models import efficientnet as jeff
from vision_toolbox_tpu.models import mobilenet as jmob
from vision_toolbox_tpu.models.base import create_backbone as jax_create_backbone
from vision_toolbox_tpu.models.base import list_backbones as jax_list_backbones
from vision_toolbox_tpu.models.mbconv import MBConv as JaxMBConv
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models import efficientnet, mobilenet
from vision_toolbox_tpu_torch.models.mbconv import MBConv, make_divisible
from vision_toolbox_tpu_torch.nn.layers import StochasticDepth
from vision_toolbox_tpu_torch.utils.export import export_model
from vision_toolbox_tpu_torch.utils.jax_bridge import _convert

MODEL_TOL = 5e-4
NAMES = [f"efficientnet_b{i}" for i in range(8)] + ["mobilenet_v3_large", "mobilenet_v3_small"]
SHORT = ((3, 16, 16, True, "relu", 2), (3, 32, 16, False, "relu", 1),
         (5, 48, 24, True, "hardswish", 2), (5, 48, 24, True, "hardswish", 1))
NARROW = {  # (JAX model, port model); drop-path set per test
    "efficientnet": (lambda **kw: jeff.EfficientNet(width_mult=0.25, depth_mult=0.5, **kw),
                     lambda **kw: efficientnet.EfficientNet(0.25, 0.5, device="cpu", **kw)),
    "mobilenet": (lambda **kw: jmob.MobileNetV3(config=SHORT, last_channels=64, **kw),
                  lambda **kw: mobilenet.MobileNetV3(SHORT, 64, device="cpu", **kw)),
}
SEMANTICS = {  # (act, SE act, SE gate, kernel, stride)
    "mobilenetv3": ("hardswish", "relu", "hardsigmoid", 3, 1),
    "efficientnet": ("silu", "silu", "sigmoid", 5, 2),
}
SD0 = {"efficientnet": dict(stochastic_depth=0.0), "mobilenet": {}}


def _mbconv_pair(semantics: str, dtype=None):
    act, se_act, se_gate, k, s = SEMANTICS[semantics]
    jm = JaxMBConv(24, 8, k, s, se_channels=6, se_act=se_act, se_gate=se_gate, act=act,
                   dtype=dtype and DTYPES[dtype][0])
    pm = MBConv(8, 24, 8, k, s, se_channels=6, se_act=se_act, se_gate=se_gate, act=act,
                dtype=dtype and DTYPES[dtype][1], generator=torch.Generator().manual_seed(0))
    return jm, pm


@pytest.mark.parametrize("semantics", list(SEMANTICS))
def test_mbconv_matches_jax(semantics):
    """Expand → depthwise (K9's plain version at stride 1, a grouped conv at
    stride 2) → SE → project (+ the residual at stride 1), f32."""
    x = np.random.default_rng(1).standard_normal((2, 9, 9, 8)).astype(np.float32)
    hold_module(*_mbconv_pair(semantics), x)


def test_mbconv_k9_path_matches_the_jax_kernel():
    """bf16, eval mode: the port's MBConv (its depthwise conv K9's plain
    version) against the JAX MBConv with its K9 in interpret mode, and
    against its default lax conv (rel L2)."""
    jm, pm = _mbconv_pair("mobilenetv3", "bfloat16")
    x = np.random.default_rng(2).standard_normal((2, 9, 9, 8)).astype(np.float32)
    variables = variables_for(jm, jnp.asarray(x), seed=5)
    load(pm, variables)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).float().numpy()
    lax = np.asarray(jm.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    original = jdc.use_depthwise_kernel
    jdc.use_depthwise_kernel = lambda *a: True
    try:
        k9 = np.asarray(jm.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    finally:
        jdc.use_depthwise_kernel = original
    assert_matches_kernel(got, k9)
    assert rel_l2(got, lax) <= REL_L2


_X = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_feature_maps():
    """Per narrow model (no drop-path: its draws are held in the train
    steps), its variables and the JAX feature taps per (dtype, train)."""
    out = {}
    for name, (jax_model, _) in NARROW.items():
        variables = variables_for(jax_model(**SD0[name]), jnp.zeros((1, 64, 64, 3)), seed=4)
        out[name] = variables, {}
        for dtype, (jdt, _) in DTYPES.items():
            jm = jax_model(dtype=jdt, **SD0[name])
            for train in (False, True):
                fmaps = jax.jit(lambda v, x, jm=jm, train=train: jm.apply(
                    v, x, train, method="get_feature_maps",
                    mutable=["batch_stats"] if train else False))
                maps = fmaps(variables, jnp.asarray(_X))
                maps = maps[0] if train else maps
                out[name][1][dtype, train] = [np.asarray(m.astype(jnp.float32)) for m in maps]
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(NARROW))
def test_narrow_feature_taps_match_jax(jax_feature_maps, name, dtype):
    variables, want_all = jax_feature_maps[name]
    tdt = DTYPES[dtype][1]
    pm = load(NARROW[name][1](dtype=tdt, **SD0[name]), variables)
    jm = NARROW[name][0]()
    assert (pm.out_channels_list, pm.stride) == (jm.out_channels_list, jm.stride)
    for train in (False, True):
        want = want_all[dtype, train]
        with torch.no_grad():
            got = pm.get_feature_maps(torch.from_numpy(_X), train=train)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        assert [g.shape[-1] for g in got] == list(pm.out_channels_list)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == tdt
            g = g.float().numpy()
            if dtype == "float32":
                tol = MODEL_TOL if train else TOL
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
            else:
                own = rel_l2(w, want_all["float32", train][i])
                assert rel_l2(g, w) <= max(REL_L2, 2 * own), (i, own)


@pytest.mark.parametrize("name", list(NARROW))
def test_narrow_gradients_match_jax(name):
    """f32, train mode: every tap, the running statistics, and the
    gradients of all taps to the input and every parameter. Each block's
    project BN feeds the taps only through 1×1 convs into train-mode BNs
    (the next block's expansion, the last conv), so its bias gradient is
    zero in exact arithmetic and held as zero."""
    jax_model, port_model = NARROW[name]
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    hold_module(jax_model(**SD0[name]), port_model(**SD0[name]), x, method="get_feature_maps",
                tol=MODEL_TOL, zero_grad=lambda n: n.endswith("project.norm.bias"))


_F32_RUNS: dict = {}
# 32 px would leave the EfficientNet 1 × 1 last maps (BN over 4 values); the
# MobileNet runs there: at 48 and 64 px a depthwise input sits within f32
# noise of a ReLU kink (tests/torch_convnets.py)
STEP_SHAPES = {"efficientnet": (4, 64, 64, 3), "mobilenet": (4, 32, 32, 3)}


def _drop_paths() -> int:
    """The narrow EfficientNet's drop-path draws a step (residual blocks
    with a rate above 0)."""
    pm = NARROW["efficientnet"][1]()
    return sum(1 for m in pm.modules() if isinstance(m, StochasticDepth) and m.p > 0)


def _f32_run(name: str, n_steps: int, monkeypatch):
    """The f32 steps of ``name`` on both sides, run once per file (their
    drop-path masks fed to both)."""
    if name not in _F32_RUNS:
        per_step = _drop_paths() if name == "efficientnet" else 0
        masks = DropPathMasks(monkeypatch, STEP_SHAPES[name][0], max(per_step, 1))
        jax_model, port_model = NARROW[name]
        _F32_RUNS[name] = run_steps(jax_model(dtype=jnp.float32),
                                    port_model(dtype=torch.float32), "float32", n_steps,
                                    STEP_SHAPES[name])
        assert (masks.jax_calls, masks.port_calls) == (per_step, per_step * n_steps)
    return _F32_RUNS[name]


@pytest.mark.parametrize("dtype,name,n_steps", [("float32", "efficientnet", 2),
                                                ("bfloat16", "efficientnet", 2),
                                                ("float32", "mobilenet", 2)])
def test_narrow_train_steps_match_jax(monkeypatch, dtype, name, n_steps):
    """Loss, parameters, BN statistics and momentum buffers after each step
    (step 0 MixUp, step 1 CutMix); EfficientNet's drop-path in its three
    residual blocks past the first (rates 0.2·i/10) with the same keep
    masks on both sides (mask i mod n: the jitted JAX step draws once, when
    traced)."""
    f32 = _f32_run(name, n_steps, monkeypatch)
    if dtype == "float32":
        check_steps(dtype, *f32)
        return
    per_step = _drop_paths()
    assert per_step == 3
    masks = DropPathMasks(monkeypatch, STEP_SHAPES[name][0], per_step)
    jax_model, port_model = NARROW[name]
    losses, states = run_steps(jax_model(dtype=jnp.bfloat16), port_model(dtype=torch.bfloat16),
                               dtype, n_steps, STEP_SHAPES[name])
    assert (masks.jax_calls, masks.port_calls) == (per_step, per_step * n_steps)
    check_steps(dtype, losses, states, f32)


def test_out_channels_and_registry_match_jax():
    """``out_channels_list`` and ``stride`` of all 10 names (the port's
    models built on the meta device), ``make_divisible``, and the registry's
    names."""
    assert sorted(n for n in list_backbones() if n.startswith(("efficientnet", "mobilenet"))) \
        == sorted(n for n in jax_list_backbones() if n.startswith(("efficientnet", "mobilenet"))) \
        == sorted(NAMES)
    for name in NAMES:
        jm = jax_create_backbone(name)
        with torch.device("meta"):
            pm = create_backbone(name, device="meta")
        assert (pm.out_channels_list, pm.stride) == (jm.out_channels_list, jm.stride), name
    from vision_toolbox_tpu.models.mbconv import make_divisible as jax_make_divisible

    for v in (3.5, 8, 10, 20, 28, 44.8, 67.2, 112 * 1.1, 1280 * 1.4, 320 * 1.8):
        assert make_divisible(v) == jax_make_divisible(v), v


def _shape_leaves(shapes):
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        yield tuple(k.key for k in path), s.shape


@pytest.mark.parametrize("name", ["efficientnet_b0", "mobilenet_v3_large"])
def test_full_size_shapes_match_jax(name):
    """Every full-size parameter's and BN statistic's bridged shape, from
    ``jax.eval_shape`` of the JAX init, equals the meta-device port
    model's; efficientnet_b0 has 12 stride-1 depthwise convs (K9 on the
    card), mobilenet_v3_large 11."""
    jm = jax_create_backbone(name)
    shapes = jax.eval_shape(lambda: jm.init_variables(0, 64))
    want = {}
    for kind in ("params", "batch_stats"):
        for path, shape in _shape_leaves(shapes[kind]):
            key, value = _convert(path, np.broadcast_to(np.float32(0), shape))
            want[key] = tuple(value.shape)
    with torch.device("meta"):
        pm = create_backbone(name, device="meta")
    assert {n: tuple(t.shape) for n, t in pm.state_dict().items()} == want
    depthwise = sum(1 for m in pm.modules() if getattr(m, "depthwise", False))
    assert depthwise == {"efficientnet_b0": 12, "mobilenet_v3_large": 11}[name]


def test_default_device_is_the_card():
    """With no ``device`` the models are built on the card; without a card
    the constructors raise instead of staying on the CPU."""
    for build in (lambda: efficientnet.EfficientNet(0.25, 0.5),
                  lambda: mobilenet.MobileNetV3(SHORT, 64)):
        if torch.cuda.is_available():
            assert next(build().parameters()).is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()


def test_exported_program_calls_the_kernels_ops():
    """The served narrow EfficientNet carries one ``vtt::depthwise_conv2d``
    per stride-1 block and no backward op, and computes the eager forward
    on CPU."""
    pm = NARROW["efficientnet"][1](dtype=torch.bfloat16).eval()
    stride1 = sum(1 for blocks in pm.stages for b in blocks if b.stride == 1)
    blob = export_model(pm, (2, 64, 64, 3))
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("vtt.depthwise_conv2d.default") == stride1 == 6
    assert not [t for t in targets if "bwd" in t or "backward" in t]
    x = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(program.module()(x), pm(x))
