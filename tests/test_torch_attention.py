"""Port of the attention core (vision_toolbox_tpu_torch/ops/attention.py) vs
the JAX ``dot_product_attention`` on CPU, f32: same math, only the f32
summation order differs, so 1e-5. Also the rule that names the unported TPU
kernel (K2 short attention) a shape would need on a CUDA tensor; K6 (flash)
is ported and named by none."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_toolbox_tpu.ops.attention import dot_product_attention as jax_attention
from vision_toolbox_tpu_torch.ops import attention as port


@pytest.mark.parametrize("T,S,bias", [(17, 17, False), (1, 16, False), (9, 12, True)])
def test_attention_matches_jax(T, S, bias):
    rng = np.random.default_rng(T + S)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(2, T, 4, 32), f(2, S, 4, 32), f(2, S, 4, 32)
    b = f(1, 4, T, S) if bias else None
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    bias=None if b is None else jnp.asarray(b)))
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = port.dot_product_attention(t(q), t(k), t(v), bias=t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_unported_kernel_rule():
    # vit_b_16 self-attention (T=S=197, head_dim 64, 8·12 pairs) is K2's shape
    assert port._unported_kernel(197, 197, 64, 96, has_bias=False).startswith("K2")
    assert port._unported_kernel(197, 197, 64, 96, has_bias=True) is None
    assert port._unported_kernel(197, 197, 64, 32, has_bias=False) is None  # few pairs
    assert port._unported_kernel(1, 196, 64, 96, has_bias=False) is None  # MAP probe
    assert port._unported_kernel(1024, 1024, 64, 8, has_bias=True) is None  # K6: ported
    assert port._unported_kernel(1025, 1025, 64, 8, has_bias=False) is None
