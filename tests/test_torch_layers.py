"""The port's conv primitives (vision_toolbox_tpu_torch/nn/layers.py,
nn/norm.py, nn/initializers.py) vs the JAX package's: ``ConvNormAct`` over
kernel sizes, strides, groups (incl. the depthwise branch), norms and every
activation, in train and eval mode; ``torch_pad``; the Kaiming-normal init.

Bridged variables, f32, NHWC numpy inputs. Tolerance rtol = atol = 1e-5
(f32 summation order of the convolution and the batch statistics).
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
