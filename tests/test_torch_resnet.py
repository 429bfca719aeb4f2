"""The port's ResNet/ResNeXt/Wide-ResNet and RegNet X/Y
(vision_toolbox_tpu_torch/models/resnet.py, regnet.py) vs the JAX modules.

Variables are drawn with numpy on the JAX init's shapes and carried into
the port through ``utils/jax_bridge.py`` with ``strict=True``
(tests/torch_convnets.py). No TPU kernel runs in these models: cuDNN runs
their convs on the card, grouped ones too, as XLA does in the JAX package.

- The blocks: ``BasicBlock`` (with and without its downsample),
  ``Bottleneck`` grouped (ResNeXt) and wide, ``RegNetBlock`` X (stride 2)
  and Y (SE of a quarter of the block input): eval and train outputs, the
  running statistics a train-mode call leaves, the input and parameter
  gradients in train mode.
- Narrow models (ResNet of BasicBlocks and a grouped-Bottleneck ResNeXt,
  one block a stage, the published widths; a RegNetY of 16/32/64 channels
  with a two-block last stage): every feature map, eval and train, f32 and
  bf16; train steps.
- ``_generate_widths`` and the group-width rounding for all 14 RegNets,
  ``out_channels_list`` and ``stride`` for all 23 names, the bridged
  full-size shapes of three, the registry (all 110 names equal to the JAX
  package's), the default device and the exported program.

Tolerances: f32 forwards and running statistics rtol = atol = 1e-5 for a
block, 5e-4 for a whole model (a chain of train-mode BNs whose fast
variance E[x²] − μ² cancels: the narrow ResNeXt read 1.7e-4 at its last
stage), gradients 1e-4 after dividing by max(1, max|JAX|) (f32 summation
order of the convolutions and batch statistics); bf16 feature maps rel L2 ≤ 1e-2, or
in train mode within twice the JAX package's own bf16 error against its f32
forward where that is larger (batch statistics over few values a channel
amplify bf16 rounding flips in both packages); train steps as
tests/torch_convnets.py sets out.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import io

import numpy as np
import pytest
import torch
from torch_convnets import (
    DTYPES, REL_L2, check_steps, hold_module, load, rel_l2, run_steps, variables_for,
)

import jax
import jax.numpy as jnp

from vision_toolbox_tpu.models import regnet as jregnet
from vision_toolbox_tpu.models import resnet as jresnet
from vision_toolbox_tpu.models.base import create_backbone as jax_create_backbone
from vision_toolbox_tpu.models.base import list_backbones as jax_list_backbones
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models import regnet, resnet
from vision_toolbox_tpu_torch.utils.export import export_model
from vision_toolbox_tpu_torch.utils.jax_bridge import _convert

MODEL_TOL = 5e-4  # whole models: a chain of train-mode BNs
NAMES = sorted(jresnet._RESNET_VARIANTS) + sorted(jregnet._REGNET_X) + sorted(jregnet._REGNET_Y)
NARROW = {  # (JAX module, port module)
    "resnet": (lambda **kw: jresnet.ResNet(depths=(1, 1, 1, 1), **kw),
               lambda **kw: resnet.ResNet((1, 1, 1, 1), device="cpu", **kw)),
    "resnext": (lambda **kw: jresnet.ResNet(depths=(1, 1, 1, 1), bottleneck=True, groups=4,
                                            width_per_group=8, **kw),
                lambda **kw: resnet.ResNet((1, 1, 1, 1), True, 4, 8, device="cpu", **kw)),
    "regnet_y": (lambda **kw: jregnet.RegNet(depth=4, w0=16, wa=16.0, wm=2.0, group_width=8,
                                             se_ratio=0.25, **kw),
                 lambda **kw: regnet.RegNet(4, 16, 16.0, 2.0, 8, 0.25, device="cpu", **kw)),
}
_GEN = lambda: torch.Generator().manual_seed(0)  # noqa: E731
BLOCKS = {  # (JAX block, port block, input channels, stride of its map)
    "basic_down": (lambda: jresnet.BasicBlock(16, 2),
                   lambda: resnet.BasicBlock(8, 16, 2, generator=_GEN()), 8),
    "basic": (lambda: jresnet.BasicBlock(16, 1),
              lambda: resnet.BasicBlock(16, 16, 1, generator=_GEN()), 16),
    "bottleneck_grouped": (lambda: jresnet.Bottleneck(64, 2, groups=4, width_per_group=8),
                           lambda: resnet.Bottleneck(32, 64, 2, 4, 8, generator=_GEN()), 32),
    "bottleneck_wide": (lambda: jresnet.Bottleneck(64, 1, width_per_group=128),
                        lambda: resnet.Bottleneck(64, 64, 1, 1, 128, generator=_GEN()), 64),
    "regnet_x": (lambda: jregnet.RegNetBlock(32, 2, 8),
                 lambda: regnet.RegNetBlock(16, 32, 2, 8, generator=_GEN()), 16),
    "regnet_y": (lambda: jregnet.RegNetBlock(32, 1, 8, 0.25),
                 lambda: regnet.RegNetBlock(32, 32, 1, 8, 0.25, generator=_GEN()), 32),
}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_blocks_match_jax(block):
    jax_block, port_block, cin = BLOCKS[block]
    x = np.random.default_rng(1).standard_normal((2, 8, 8, cin)).astype(np.float32)
    hold_module(jax_block(), port_block(), x)


def test_narrow_resnet_gradients_match_jax():
    """f32, train mode: every feature map's value, the running statistics,
    and the gradients of all four stage outputs through the stem's 7×7/2
    conv and the 3×3/2 max pool, on a zero-mean input (on [0, 1) images
    the stem's train-mode statistics cancel more, and a max-pool window
    whose two largest values lie within that noise sends its gradient to
    another tap in each package: tests/torch_convnets.py)."""
    jax_model, port_model = NARROW["resnet"]
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    hold_module(jax_model(), port_model(), x, method="get_feature_maps", tol=MODEL_TOL)


_X = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)  # 2 × 2 last maps


@pytest.fixture(scope="module")
def jax_feature_maps():
    """Per narrow model, its variables and the JAX feature maps per (dtype,
    train), each forward jitted once."""
    out = {}
    for name, (jax_model, _) in NARROW.items():
        variables = variables_for(jax_model(), jnp.zeros((1, 64, 64, 3)), seed=4)
        out[name] = variables, {}
        for dtype, (jdt, _) in DTYPES.items():
            jm = jax_model(dtype=jdt)
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
def test_narrow_feature_maps_match_jax(jax_feature_maps, name, dtype):
    variables, want_all = jax_feature_maps[name]
    tdt = DTYPES[dtype][1]
    pm = load(NARROW[name][1](dtype=tdt), variables)
    jm = NARROW[name][0]()
    assert (pm.out_channels_list, pm.stride) == (jm.out_channels_list, jm.stride)
    for train in (False, True):
        want = want_all[dtype, train]
        with torch.no_grad():
            got = pm.get_feature_maps(torch.from_numpy(_X), train=train)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == tdt
            g = g.float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=MODEL_TOL, atol=MODEL_TOL)
            elif not train:
                assert rel_l2(g, w) <= REL_L2, i
            else:
                own = rel_l2(w, want_all["float32", train][i])
                assert rel_l2(g, w) <= max(REL_L2, 2 * own), (i, own)


_F32_RUNS: dict = {}
STEP_SHAPE = (4, 32, 32, 3)


def _f32_run(name: str, n_steps: int):
    """The f32 steps of ``name`` on both sides, run once per file."""
    if name not in _F32_RUNS:
        jax_model, port_model = NARROW[name]
        _F32_RUNS[name] = run_steps(jax_model(dtype=jnp.float32),
                                    port_model(dtype=torch.float32), "float32", n_steps,
                                    STEP_SHAPE)
    return _F32_RUNS[name]


@pytest.mark.parametrize("dtype,name,n_steps", [("float32", "regnet_y", 2),
                                                ("bfloat16", "regnet_y", 2),
                                                ("float32", "resnet", 1)])
def test_narrow_train_steps_match_jax(dtype, name, n_steps):
    """Loss, parameters, BN statistics and momentum buffers after each step
    (step 0 MixUp, step 1 CutMix)."""
    if dtype == "float32":
        check_steps(dtype, *_f32_run(name, n_steps))
        return
    jax_model, port_model = NARROW[name]
    losses, states = run_steps(jax_model(dtype=jnp.bfloat16), port_model(dtype=torch.bfloat16),
                               dtype, n_steps, STEP_SHAPE)
    check_steps(dtype, losses, states, _f32_run(name, n_steps))


def test_regnet_widths_match_jax():
    """``_generate_widths`` and the group-width rounding of every RegNet."""
    for table in (regnet._REGNET_X, regnet._REGNET_Y):
        for name, (depth, w0, wa, wm, g) in table.items():
            assert regnet._generate_widths(depth, w0, wa, wm) == jregnet._generate_widths(
                depth, w0, wa, wm), name
            jm = jregnet.RegNet(depth=depth, w0=w0, wa=wa, wm=wm, group_width=g)
            assert regnet.stage_config(depth, w0, wa, wm, g) == jm._stage_config, name
    assert sorted(regnet._REGNET_X) == sorted(jregnet._REGNET_X)
    assert sorted(regnet._REGNET_Y) == sorted(jregnet._REGNET_Y)


def test_out_channels_and_registry_match_jax():
    """``out_channels_list`` and ``stride`` of all 23 names (the port's
    models built on the meta device), and the registry: all 110 names of
    the JAX package."""
    assert list_backbones() == jax_list_backbones() and len(list_backbones()) == 110
    assert sorted(n for n in list_backbones() if n.startswith(("res", "wide_", "regnet"))) == \
        sorted(NAMES)
    for name in NAMES:
        jm = jax_create_backbone(name)
        with torch.device("meta"):
            pm = create_backbone(name, device="meta")
        assert (pm.out_channels_list, pm.stride) == (jm.out_channels_list, jm.stride), name


def _shape_leaves(shapes):
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        yield tuple(k.key for k in path), s.shape


@pytest.mark.parametrize("name", ["resnet18", "resnext50_32x4d", "regnet_y_1_6gf"])
def test_full_size_shapes_match_jax(name):
    """Every full-size parameter's and BN statistic's bridged shape, from
    ``jax.eval_shape`` of the JAX init, equals the meta-device port
    model's."""
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


def test_default_device_is_the_card():
    """With no ``device`` the models are built on the card; without a card
    the constructors raise instead of staying on the CPU."""
    for build in (lambda: resnet.ResNet((1, 1, 1, 1)),
                  lambda: regnet.RegNet(4, 16, 16.0, 2.0, 8, 0.25)):
        if torch.cuda.is_available():
            assert next(build().parameters()).is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()


def test_exported_program_equals_eager():
    """The served RegNetY program (no custom op: no kernel runs in these
    models) holds no backward op and computes the eager forward on CPU."""
    pm = NARROW["regnet_y"][1](dtype=torch.bfloat16).eval()
    blob = export_model(pm, (2, 32, 32, 3))
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert not [t for t in targets if t.startswith("vtt.") or "bwd" in t or "backward" in t]
    x = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(program.module()(x), pm(x))
