"""The port's necks and the layers they and the detectors use
(vision_toolbox_tpu_torch/models/necks.py, nn/layers.py ``SPPBlock``,
``DeformableConv2d``, ops/deform_conv.py) vs the JAX package's.

Variables are drawn with numpy on the JAX init's shapes and carried into
the port through ``utils/jax_bridge.py`` with ``strict=True``
(tests/torch_convnets.py); maps are NHWC, three levels of 8/16/32 channels
at 16², 8² and 4² unless stated.

- ``resize_nearest`` bit-equal to ``jax.image.resize(..., "nearest")`` at
  2.0 and 0.5 on even and odd maps, f32 and bf16 (torch's ``"nearest"``
  reads other pixels at 0.5: held as a control).
- ``FPN`` for each fuse (concat, sum, avg, max) top-down and bottom-up,
  ``PAN``, ``WeightedFeatureFusion`` and ``BiFPN`` with the separable and
  the conv-norm-act block: eval and train outputs, running statistics,
  input and parameter gradients, f32; ``WeightedFeatureFusion`` also in
  bf16, and once against JAX's K9 in interpret mode (its separable conv's
  depthwise half: the port runs K9's plain version on the CPU).
- ``SPPBlock`` with max and avg pooling, and ``avg_pool_torch``'s rounding
  in bf16 through it.
- ``deform_conv2d`` v1 (no mask) and v2, stride 2, dilation 2, padding,
  offsets that push samples off the map, forward and the gradients to x,
  weight, offset, mask and bias; ``DeformableConv2d`` bridged (its raw
  (k, k, C, Co) ``kernel`` by the HWIO rule).
- The README's composition: darknet_yolov5n's last four maps → PAN.

Tolerances: f32 rtol = atol = 1e-5, gradients 1e-4 after dividing by
max(1, max|JAX|) (f32 summation order), the darknet_yolov5n → PAN
composition 5e-4 (a chain of BNs); bf16 rel L2 ≤ 1e-2, against JAX's K9 by
tests/torch_parity.py's rule.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
import torch
from torch_convnets import DTYPES, REL_L2, TOL, hold_module, load, rel_l2, variables_for
from torch_parity import assert_matches_kernel

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.depthwise_conv as jdc
from vision_toolbox_tpu.models import necks as jnecks
from vision_toolbox_tpu.models.base import create_backbone as jax_create_backbone
from vision_toolbox_tpu.nn import layers as jlayers
from vision_toolbox_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from vision_toolbox_tpu_torch import create_backbone
from vision_toolbox_tpu_torch.models import necks
from vision_toolbox_tpu_torch.nn import layers
from vision_toolbox_tpu_torch.ops.deform_conv import deform_conv2d
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

CHANNELS = (8, 16, 32)
_GEN = lambda: torch.Generator().manual_seed(0)  # noqa: E731


def _maps(channels=CHANNELS, base=16, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, base >> i, base >> i, c)).astype(np.float32)
            for i, c in enumerate(channels)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_resize_nearest_is_bit_equal_to_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    for shape in ((2, 8, 8, 3), (2, 7, 7, 3), (1, 5, 9, 2), (1, 6, 3, 4)):
        x = rng.standard_normal(shape).astype(np.float32)
        for scale in (2.0, 0.5):
            want = np.asarray(jnecks.resize_nearest(jnp.asarray(x, jdt), scale).astype(
                jnp.float32))
            t = torch.from_numpy(x).to(tdt)
            got = necks.resize_nearest(t, scale)
            assert got.dtype == tdt
            assert np.array_equal(got.float().numpy(), want), (shape, scale)
            if scale == 0.5:  # torch's "nearest" takes the even pixels, JAX the odd
                plain = torch.nn.functional.interpolate(
                    t.permute(0, 3, 1, 2), size=want.shape[1:3], mode="nearest")
                assert not np.array_equal(plain.permute(0, 2, 3, 1).float().numpy(), want)


FUSES = ["concat", "sum", "avg", "max"]


@pytest.mark.parametrize("top_down", [True, False], ids=["top_down", "bottom_up"])
@pytest.mark.parametrize("fuse", FUSES)
def test_fpn_matches_jax(fuse, top_down):
    """Lateral convs (the 16-wide level keeps its width: no conv), the
    fuse, the 3×3 output blocks."""
    jm = jnecks.FPN(CHANNELS, 16, fuse, top_down=top_down)
    pm = necks.FPN(CHANNELS, 16, fuse, top_down=top_down, device="cpu", generator=_GEN())
    assert pm.lateral_1.conv is None
    hold_module(jm, pm, _maps())


@pytest.mark.parametrize("block", ["separable", "conv_norm_act"])
def test_pan_and_bifpn_match_jax(block):
    """PAN (top-down FPN then bottom-up) and a two-layer BiFPN, each with
    the block."""
    hold_module(jnecks.PAN(CHANNELS, 16, block=block),
                necks.PAN(CHANNELS, 16, block=block, device="cpu", generator=_GEN()), _maps())
    hold_module(jnecks.BiFPN(CHANNELS, 16, num_layers=2, block=block),
                necks.BiFPN(CHANNELS, 16, 2, block, device="cpu", generator=_GEN()), _maps())


def test_weighted_feature_fusion_matches_jax():
    """Three inputs: f32 values and gradients; then, one weight driven below
    zero (ReLU'd away), the f32 and bf16 forwards (in bf16 each weight is
    cast to x's type before its product and the division runs in x's
    type)."""
    xs = [np.random.default_rng(i).standard_normal((2, 8, 8, 16)).astype(np.float32)
          for i in range(3)]
    jm = jnecks.WeightedFeatureFusion(3)
    pm = necks.WeightedFeatureFusion(16, 3, generator=_GEN())
    hold_module(jm, pm, xs)
    variables = variables_for(jm, [jnp.asarray(x) for x in xs], seed=6)
    variables["params"]["weights"][1] = -0.5
    for dtype, (jdt, tdt) in DTYPES.items():
        jm = jnecks.WeightedFeatureFusion(3, dtype=jdt)
        pm = load(necks.WeightedFeatureFusion(16, 3, dtype=tdt, generator=_GEN()), variables)
        want = np.asarray(jm.apply(variables, [jnp.asarray(x, jdt) for x in xs]).astype(
            jnp.float32))
        with torch.no_grad():
            got = pm([torch.from_numpy(x).to(tdt) for x in xs]).float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        else:
            assert rel_l2(got, want) <= REL_L2


def test_separable_fusion_k9_path_matches_the_jax_kernel():
    """bf16, eval mode: a two-input fusion whose separable conv's depthwise
    half is K9's plain version here and JAX's K9 in interpret mode there."""
    xs = [np.random.default_rng(i).standard_normal((2, 8, 8, 16)).astype(np.float32)
          for i in range(2)]
    jm = jnecks.WeightedFeatureFusion(2, dtype=jnp.bfloat16)
    variables = variables_for(jm, [jnp.asarray(x) for x in xs], seed=7)
    pm = load(necks.WeightedFeatureFusion(16, 2, dtype=torch.bfloat16, generator=_GEN()),
              variables)
    with torch.no_grad():
        got = pm([torch.from_numpy(x).to(torch.bfloat16) for x in xs]).float().numpy()
    original = jdc.use_depthwise_kernel
    jdc.use_depthwise_kernel = lambda *a: True
    try:
        want = jm.apply(variables, [jnp.asarray(x, jnp.bfloat16) for x in xs])
    finally:
        jdc.use_depthwise_kernel = original
    assert_matches_kernel(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_spp_block_matches_jax(pool):
    """Three chained 5×5 stride-1 pools, concatenated: f32 values and input
    gradients; bf16 values (avg_pool_torch divides in x's type there)."""
    jm, pm = jlayers.SPPBlock(pool=pool), layers.SPPBlock(pool=pool)
    x = np.random.default_rng(3).standard_normal((2, 9, 9, 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jm.apply({}, x), jnp.asarray(x))
    ct = np.random.default_rng(4).standard_normal(want.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    got = pm(tx)
    got.backward(torch.from_numpy(ct))
    assert got.shape == (2, 9, 9, 12)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-4)
    want = np.asarray(jm.apply({}, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = pm(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert rel_l2(got, want) <= REL_L2


DEFORM_CASES = {  # (k, stride, padding, dilation, v2)
    "v2": (3, 1, 1, 1, True),
    "v1": (3, 1, 1, 1, False),
    "stride2_dilation2": (3, 2, 2, 2, True),
}


@pytest.mark.parametrize("case", list(DEFORM_CASES))
def test_deform_conv2d_matches_jax(case):
    """The sampling op alone: offsets N(0, 1.5²) with every tenth at ±6
    (past the map's edge for most of its samples), forward and the
    gradients to x, weight, offset, mask and bias."""
    k, s, p, d, v2 = DEFORM_CASES[case]
    rng = np.random.default_rng(5)
    B, H, W, C, Co = 2, 7, 9, 4, 6
    Ho, Wo = (H + 2 * p - d * (k - 1) - 1) // s + 1, (W + 2 * p - d * (k - 1) - 1) // s + 1
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((k, k, C, Co)) * 0.3).astype(np.float32)
    offset = (rng.standard_normal((B, Ho, Wo, 2 * k * k)) * 1.5).astype(np.float32)
    offset.reshape(-1)[::10] = 6 * np.sign(offset.reshape(-1)[::10])
    mask = rng.random((B, Ho, Wo, k * k)).astype(np.float32) if v2 else None
    bias = rng.standard_normal(Co).astype(np.float32)
    args = [x, w, offset] + ([mask] if v2 else []) + [bias]

    def jfn(x, w, offset, *rest):
        m, b = (rest[0], rest[1]) if v2 else (None, rest[0])
        return jax_deform_conv2d(x, w, offset, m, b, stride=s, padding=p, dilation=d)

    ct = rng.standard_normal((B, Ho, Wo, Co)).astype(np.float32)
    want, jgrads = jax.jit(lambda a, c: (jfn(*a), jax.vjp(jfn, *a)[1](c)))(
        [jnp.asarray(a) for a in args], jnp.asarray(ct))
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    tw = t[1].permute(3, 2, 0, 1)  # (Co, C, k, k), the bridge's layout
    got = deform_conv2d(t[0], tw, t[2], t[3] if v2 else None, t[-1], stride=s, padding=p,
                        dilation=d)
    got.backward(torch.from_numpy(ct))
    assert got.shape == (B, Ho, Wo, Co)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    names = ["x", "weight", "offset"] + (["mask"] if v2 else []) + ["bias"]
    for name, a, g in zip(names, t, jgrads):
        g = np.asarray(g)
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(a.grad.numpy() / scale, g / scale, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("v2,stride", [(False, 1), (True, 2)], ids=["v1", "v2_stride2"])
def test_deformable_conv2d_module_matches_jax(v2, stride):
    """``DeformableConv2d`` (3×3, padding 1), bridged: its offset conv (and
    in v2 the sigmoid mask conv), the sampling and the bias; values and the
    gradients to x and every parameter."""
    jm = jlayers.DeformableConv2d(8, 3, stride, padding=1, v2=v2)
    pm = layers.DeformableConv2d(4, 8, 3, stride, padding=1, v2=v2, generator=_GEN())
    x = np.random.default_rng(6).standard_normal((2, 9, 9, 4)).astype(np.float32)
    variables = variables_for(jm, jnp.asarray(x), seed=8)
    variables["params"]["conv_offset"]["kernel"] *= 4  # offsets of a few pixels
    load(pm, variables)
    assert pm.weight.shape == (8, 4, 3, 3)
    fn = lambda p, x: jm.apply({"params": p}, x)  # noqa: E731
    ct = np.random.default_rng(7).standard_normal(
        jax.eval_shape(fn, variables["params"], jnp.asarray(x)).shape).astype(np.float32)
    want, (jgrads, jdx) = jax.jit(lambda p, x, c: (fn(p, x), jax.vjp(fn, p, x)[1](c)))(
        variables["params"], jnp.asarray(x), jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    got = pm(tx)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-4)
    want_grads = flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    assert sorted(want_grads) == sorted(n for n, _ in pm.named_parameters())
    for n, p in pm.named_parameters():
        w = want_grads[n].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale, rtol=1e-4, atol=1e-4,
                                   err_msg=n)


def test_darknet_yolov5n_to_pan_composition():
    """feats = darknet_yolov5n.get_feature_maps(x)[-4:] → PAN(·, 32), the
    README's composition (f32, eval mode, 64 px)."""
    jbb = jax_create_backbone("darknet_yolov5n")
    x = np.random.default_rng(8).standard_normal((2, 64, 64, 3)).astype(np.float32)
    bvars = variables_for(jbb, jnp.asarray(x), seed=9)
    feats = jax.jit(lambda v, x: jbb.apply(v, x, method="get_feature_maps"))(
        bvars, jnp.asarray(x))[-4:]
    channels = tuple(f.shape[-1] for f in feats)
    jneck = jnecks.PAN(channels, 32)
    nvars = variables_for(jneck, list(feats), seed=10)
    want = jax.jit(lambda v, f: jneck.apply(v, f))(nvars, list(feats))
    pbb = load(create_backbone("darknet_yolov5n", device="cpu"), bvars).eval()
    pneck = load(necks.PAN(channels, 32, device="cpu", generator=_GEN()), nvars).eval()
    with torch.no_grad():
        got = pneck(pbb.get_feature_maps(torch.from_numpy(x))[-4:])
    assert len(got) == 4 and all(g.shape[-1] == 32 for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-4)
