"""Port of the attention core (vision_toolbox_tpu_torch/ops/attention.py) vs
the JAX ``dot_product_attention`` on CPU, f32: same math, only the f32
summation order differs, so 1e-5. Also the dispatch: which shapes go to the
short-attention kernel (K2), which to the flash kernel (K6) and which to the
plain ``jax.nn`` math, as the JAX package sends them."""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

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


@pytest.mark.parametrize("T,S,H,B,N,bias,route", [
    (197, 197, 64, 8, 12, False, "k2"),  # vit_b_16 at batch 8: 96 pairs
    (197, 197, 64, 8, 12, True, "dense"),  # a bias: never K2
    (197, 197, 64, 2, 12, False, "dense"),  # 24 pairs: the op's run-time test
    (50, 197, 40, 4, 16, False, "k2"),  # cross attention, head 40
    (2, 2, 16, 64, 1, False, "k2"),  # the rule's shortest
    (513, 513, 64, 1, 64, False, "dense"),  # past MAX_SHORT_SEQ
    (197, 197, 136, 1, 64, False, "dense"),  # head past 128
    (1, 196, 64, 8, 12, False, "dense"),  # the MAP probe: T = 1
    (1024, 1024, 64, 1, 2, True, "k6"),
    (1025, 1025, 64, 1, 2, False, "dense"),
])
def test_attention_dispatch(monkeypatch, T, S, H, B, N, bias, route):
    """``dot_product_attention`` sends each shape where the JAX package
    does (``ops/attention.py``): K2 for unbiased attention inside
    ``use_short``, then K6 for ``use_pallas``'s lengths, else the plain
    math. Spies on the kernels' plain versions and on ``dense_attention``
    record which ran."""
    from vision_toolbox_tpu_torch.ops import flash_attention as fa
    from vision_toolbox_tpu_torch.ops import short_attention as sa

    ran = []
    spy = lambda name, fn: lambda *a, **kw: ran.append(name) or fn(*a, **kw)
    monkeypatch.setattr(sa, "short_attention_plain", spy("k2", sa.short_attention_plain))
    dense = spy("dense", sa.dense_attention)
    monkeypatch.setattr(sa, "dense_attention", dense)
    monkeypatch.setattr(port, "dense_attention", dense)
    monkeypatch.setattr(fa, "flash_attention_plain", spy("k6", fa.flash_attention_plain))
    g = torch.Generator().manual_seed(T + S + H)
    q = torch.randn(B, T, N, H, generator=g)
    k, v = (torch.randn(B, S, N, H, generator=g) for _ in range(2))
    b = torch.randn(1, N, T, S, generator=g) if bias else None
    with torch.no_grad():
        out = port.dot_product_attention(q, k, v, bias=b)
    assert ran == [route] and out.shape == q.shape
    assert (sa.use_short(T, S, H, B * N) and not bias) == (route == "k2")
