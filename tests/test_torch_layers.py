"""The port's conv primitives (vision_toolbox_tpu_torch/nn/layers.py,
nn/norm.py, nn/initializers.py) vs the JAX package's: ``ConvNormAct`` over
kernel sizes, strides, groups (incl. the depthwise branch), norms and every
activation, in train and eval mode; ``torch_pad``; the Kaiming-normal init;
the hard-sigmoid gate and drop-path bit-equal to the JAX package's in f32
and bf16; ``SqueezeExcitation``, ``ESEBlock``, ``max_pool_torch`` (its
gradient at tied windows bit-equal) and flax's own BatchNorm
(``LinenBatchNorm``).

Bridged variables, f32 unless stated, NHWC numpy inputs. Tolerance rtol =
atol = 1e-5 (f32 summation order of the convolution and the batch
statistics); input gradients 1e-4; ``LinenBatchNorm`` in bf16 1e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_toolbox_tpu.nn import layers as jlayers
from vision_toolbox_tpu_torch.nn import layers
from vision_toolbox_tpu_torch.nn.initializers import kaiming_normal
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

TOL = 1e-5

CASES = [  # (in, out, k, stride, groups, norm, act)
    (4, 8, 3, 1, 1, "bn", "relu"),
    (4, 8, 3, 2, 1, "bn", "leaky_relu"),
    (3, 8, 6, 2, 1, "bn", "silu"),  # the YOLOv5 stem: pad ceil(4/2) = 2
    (8, 8, 1, 1, 1, "none", "gelu"),
    (8, 8, 3, 1, 8, "bn", "relu6"),  # depthwise stride 1
    (8, 8, 5, 1, 8, "none", "hardswish"),
    (8, 8, 3, 2, 8, "bn", "hardsigmoid"),  # depthwise stride 2: a grouped conv
    (8, 4, 3, 1, 2, "bn", "swish"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_conv_norm_act_matches_jax(case):
    cin, cout, k, s, groups, norm, act = case
    jm = jlayers.ConvNormAct(cout, k, s, groups=groups, norm=norm, act=act)
    x = np.random.default_rng(0).standard_normal((2, 9, 9, cin)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    pm = layers.ConvNormAct(cin, cout, k, s, groups=groups, norm=norm, act=act,
                            generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables.get("batch_stats")),
                       strict=True)
    for train in (False, True):  # eval first: a train-mode call updates the running stats
        if train:
            want, _ = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            want = jm.apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = pm(torch.from_numpy(x), train=train)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_torch_pad_and_depthwise_gate():
    for k in range(1, 8):
        for s in (1, 2):
            assert layers.torch_pad(k, s) == jlayers.torch_pad(k, s)
    g = torch.Generator().manual_seed(0)
    assert layers.ConvNormAct(8, 8, 3, groups=8, generator=g).depthwise
    assert not layers.ConvNormAct(8, 8, 3, stride=2, groups=8, generator=g).depthwise
    assert not layers.ConvNormAct(8, 16, 3, generator=g).depthwise


@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
def test_kaiming_normal_fan_out(act):
    init = kaiming_normal(act, a=0.2, mode="fan_out")
    w = init((256, 64, 3, 3), torch.Generator().manual_seed(0))
    gain = np.sqrt(2.0) if act == "relu" else np.sqrt(2.0 / 1.04)
    assert abs(w.std().item() / (gain / np.sqrt(256 * 9)) - 1) < 0.02
    assert abs(w.mean().item()) < 2e-3


# --- the gates, pooling and norms of the Mixer/PatchConvNet/VoVNet slice ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hard_sigmoid_is_bit_equal_to_jax(dtype):
    """``hard_sigmoid`` (ESE's gate, ``ACTIVATIONS["hardsigmoid"]``) equals
    ``jax.nn.hard_sigmoid`` bit for bit on 200,000 normal·4 samples, jitted
    as a model runs it; ``F.hardsigmoid`` rounds elsewhere in f32."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    x = (np.random.default_rng(0).standard_normal(200_000) * 4).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.hard_sigmoid)(jnp.asarray(x, jdt)).astype(jnp.float32))
    t = torch.from_numpy(x).to(tdt)
    for fn in (layers.hard_sigmoid, layers.ACTIVATIONS["hardsigmoid"]):
        assert np.array_equal(fn(t).float().numpy(), want)
    if dtype == "float32":
        assert not np.array_equal(torch.nn.functional.hardsigmoid(t).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stochastic_depth_rounds_like_jax(monkeypatch, dtype):
    """``StochasticDepth`` in training: x·mask/keep_p bit-equal to the JAX
    module's on one mask (fed to both sides)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 3, 5, 7)) * 4).astype(np.float32)
    keep = rng.random(64) >= 0.3
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep.reshape(shape)))
    jm = jlayers.StochasticDepth(0.3)
    want = jax.jit(lambda x: jm.apply({}, x, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
                   )(jnp.asarray(x, jdt))
    sd = layers.StochasticDepth(0.3)
    monkeypatch.setattr(sd, "sample_scale", lambda b, train, g, device=None: torch.from_numpy(
        keep.reshape(b, 1) / np.float32(0.7)).float())
    got = sd(torch.from_numpy(x).to(tdt), train=True)
    assert got.dtype == tdt
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _bridged(jm, pm, x):
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables.get("batch_stats")),
                       strict=True)
    return variables


@pytest.mark.parametrize("block", ["se", "ese"])
def test_squeeze_excitation_and_ese_match_jax(block):
    """SE (``fc1`` → relu → ``fc2`` → sigmoid) and ESE (``linear`` → hard
    sigmoid), bridged, f32, values and input gradients."""
    x = np.random.default_rng(2).standard_normal((2, 5, 6, 16)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    pairs = {"se": (jlayers.SqueezeExcitation(4), layers.SqueezeExcitation(16, 4, generator=g)),
             "ese": (jlayers.ESEBlock(), layers.ESEBlock(16, generator=g))}
    jm, pm = pairs[block]
    variables = _bridged(jm, pm, x)
    want, vjp = jax.vjp(lambda x: jm.apply(variables, x), jnp.asarray(x))
    (want_dx,) = vjp(jnp.ones_like(want))
    tx = torch.from_numpy(x).requires_grad_()
    got = pm(tx)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-4)


def test_max_pool_ties_send_the_gradient_to_the_same_tap():
    """``max_pool_torch(x, 3, 2, 1)`` on NHWC maps: -inf padding, and at tied
    windows (an all-zero map, the post-ReLU case, and a ReLU'd map with
    many zeros) the gradient lands on the same element as JAX's
    reduce_window's, bit for bit."""
    rng = np.random.default_rng(3)
    maps = [np.zeros((1, 6, 6, 2), np.float32),
            np.maximum(rng.standard_normal((2, 9, 8, 3)), 0).astype(np.float32),
            -np.abs(rng.standard_normal((1, 5, 5, 1))).astype(np.float32)]
    for x in maps:
        ct = rng.random(jlayers.max_pool_torch(jnp.asarray(x), 3, 2, 1).shape).astype(np.float32)
        want, vjp = jax.vjp(lambda x: jlayers.max_pool_torch(x, 3, 2, 1), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(ct))
        tx = torch.from_numpy(x).requires_grad_()
        got = layers.max_pool_torch(tx, 3, 2, 1)
        got.backward(torch.from_numpy(ct))
        assert np.array_equal(got.detach().numpy(), np.asarray(want))
        assert np.array_equal(tx.grad.numpy(), np.asarray(want_dx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linen_batch_norm_matches_flax(dtype):
    """``LinenBatchNorm`` vs flax's ``nn.BatchNorm`` (PatchConvNet's), in
    train mode (output, biased running statistics) and eval mode."""
    from flax import linen as fnn

    from vision_toolbox_tpu_torch.nn.norm import LinenBatchNorm

    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    x = (np.random.default_rng(4).standard_normal((4, 3, 5, 8)) * 2 + 1).astype(np.float32)
    jm = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                 use_running_average=True))
    rng = np.random.default_rng(5)
    variables["params"] = jax.tree.map(lambda a: rng.random(a.shape, np.float32),
                                       variables["params"])
    pm = LinenBatchNorm(8, dtype=tdt)
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]),
                       strict=True)
    xj = jnp.asarray(x, jdt)
    want, mutated = jm.apply(variables, xj, use_running_average=False, mutable=["batch_stats"])
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(tdt), train=True)
    tol = TOL if dtype == "float32" else 1e-2
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    stats = flax_to_state_dict({}, jax.tree.map(np.asarray, mutated["batch_stats"]))
    for k, v in stats.items():
        np.testing.assert_allclose(pm.state_dict()[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6)
    want = jm.apply({"params": variables["params"], **mutated}, xj, use_running_average=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(tdt))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# --- the MBConv/RegNet/neck slice: hardswish, SE's act/gate pairs, avg pool ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hard_swish_is_bit_equal_to_jax(dtype):
    """``ACTIVATIONS["hardswish"]`` (x · hard_sigmoid(x), MobileNetV3's)
    equals ``jax.nn.hard_swish`` bit for bit on 200,000 normal·4 samples,
    jitted as a model runs it; ``F.hardswish`` rounds elsewhere."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    x = (np.random.default_rng(0).standard_normal(200_000) * 4).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.hard_swish)(jnp.asarray(x, jdt)).astype(jnp.float32))
    t = torch.from_numpy(x).to(tdt)
    for fn in (layers.hard_swish, layers.ACTIVATIONS["hardswish"]):
        assert np.array_equal(fn(t).float().numpy(), want)
    assert not np.array_equal(torch.nn.functional.hardswish(t).float().numpy(), want)


SE_PAIRS = [("relu", "sigmoid"), ("relu", "hardsigmoid"), ("silu", "sigmoid"),
            ("hardswish", "hardsigmoid")]


@pytest.mark.parametrize("act,gate", SE_PAIRS)
def test_squeeze_excitation_act_and_gate_match_jax(act, gate):
    """SE with each act/gate pair (PatchConvNet's and RegNetY's relu/sigmoid,
    MobileNetV3's relu/hard sigmoid, EfficientNet's silu/sigmoid, and
    hardswish/hard sigmoid), bridged, f32, values and input gradients."""
    x = (np.random.default_rng(5).standard_normal((2, 5, 6, 16)) * 2).astype(np.float32)
    jm = jlayers.SqueezeExcitation(4, act=act, gate=gate)
    pm = layers.SqueezeExcitation(16, 4, act, gate, generator=torch.Generator().manual_seed(0))
    variables = _bridged(jm, pm, x)
    want, vjp = jax.vjp(lambda x: jm.apply(variables, x), jnp.asarray(x))
    (want_dx,) = vjp(jnp.ones_like(want))
    tx = torch.from_numpy(x).requires_grad_()
    got = pm(tx)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (5, 1, 2), (3, 2, 1), (2, 2, 0)])
def test_avg_pool_torch_matches_jax(k, s, p, dtype):
    """``avg_pool_torch`` (count_include_pad: the zero-padded window sum,
    divided by k² at JAX's rounding point) against the JAX function: f32
    values and input gradients to 1e-6 (the window sums' order); bf16
    values rel L2 ≤ 1e-2 (XLA sums a bf16 window in bf16, rounding each
    add, where the port sums in f32 and rounds once: a few elements differ
    by an ulp or two)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    x = np.random.default_rng(6).standard_normal((2, 9, 8, 3)).astype(np.float32)
    jfn = jax.jit(lambda x: jlayers.avg_pool_torch(x, k, s, p))
    want = np.asarray(jfn(jnp.asarray(x, jdt)).astype(jnp.float32))
    got = layers.avg_pool_torch(torch.from_numpy(x).to(tdt), k, s, p)
    assert got.dtype == tdt and got.shape == want.shape
    if dtype == "bfloat16":
        got = got.float().numpy()
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
        return
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    ct = np.random.default_rng(7).standard_normal(want.shape).astype(np.float32)
    # un-jitted: jax.jit of the generic reduce_window's VJP fails to linearize
    _, vjp = jax.vjp(lambda x: jlayers.avg_pool_torch(x, k, s, p), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    layers.avg_pool_torch(tx, k, s, p).backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=1e-6, atol=1e-6)
