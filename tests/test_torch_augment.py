"""The port's batch augmentation (vision_toolbox_tpu_torch/ops/augment.py)
vs the JAX package's, given the JAX package's draws (tests/torch_draws.py).

Tolerances: f32 images and targets within max abs 1e-6 (same f32
operations); bf16 images within one bf16 ulp of values in [0, 1] (2⁻⁸: XLA
may keep an f32 intermediate where PyTorch rounds); CutMix boxes and
RandomErasing masks exact.
"""

import numpy as np
import pytest
import torch
from torch_draws import erase_draws, mix_draws

import jax
import jax.numpy as jnp

from vision_toolbox_tpu.ops import augment as jaug
from vision_toolbox_tpu_torch.ops import augment as aug

ATOL = 1e-6
BF16_ULP = 2.0**-8
H, W = 16, 24


def _batch(dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((6, H, W, 3), dtype=np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    return x, y


def _find_key(pred, tries=200):
    for s in range(tries):
        key = jax.random.PRNGKey(s)
        if pred(key):
            return key
    raise AssertionError("no key with the wanted draws")


def _close(got, want, dtype):
    atol = BF16_ULP if dtype == "bfloat16" else ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixup_matches_jax(dtype):
    x, y = _batch()
    key = jax.random.PRNGKey(1)
    xj, yj = jaug.mixup(key, jnp.asarray(x).astype(dtype), jnp.asarray(y), 0.2)
    lam = float(jax.random.beta(key, 0.2, 0.2))
    xt, yt = aug.mixup(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(y), lam)
    _close(xt.float().numpy(), np.asarray(xj.astype(jnp.float32)), dtype)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("clamped", [False, True])
def test_cutmix_matches_jax(clamped):
    """A box inside the image, and one clamped at an edge: λ comes from the
    clamped box's area."""
    x, y = _batch(seed=2)

    def box_clamped(key):
        d = mix_draws(jax.random.split(key)[1], H, W, 1.0, 0.0)
        x1, y1, x2, y2 = aug.cutmix_box(H, W, d.lam, d.r_x, d.r_y)
        r = 0.5 * np.sqrt(1 - d.lam)
        inside = (x2 - x1 == 2 * int(r * W)) and (y2 - y1 == 2 * int(r * H))
        return (not inside) == clamped and x2 > x1 and y2 > y1

    key = _find_key(box_clamped)
    xj, yj = jaug.cutmix_mixup(key, jnp.asarray(x), jnp.asarray(y), 1.0, 0.0)
    d = mix_draws(key, H, W, 1.0, 0.0)
    assert d.use_cutmix
    xt, yt = aug.cutmix_mixup(torch.from_numpy(x), torch.from_numpy(y), d)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("use_cutmix", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cutmix_mixup_both_branches(use_cutmix, dtype):
    x, y = _batch(seed=3)
    key = _find_key(lambda k: mix_draws(k, H, W).use_cutmix == use_cutmix)
    xj, yj = jaug.cutmix_mixup(key, jnp.asarray(x).astype(dtype), jnp.asarray(y), 1.0, 0.2)
    xt, yt = aug.cutmix_mixup(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(y),
                              mix_draws(key, H, W))
    _close(xt.float().numpy(), np.asarray(xj.astype(jnp.float32)), dtype)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)


def test_random_erasing_matches_jax():
    """p = 0.9 so most images get a box; boxes and noise exact."""
    x = np.random.default_rng(4).random((8, H, W, 3), dtype=np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jaug.random_erasing(key, jnp.asarray(x), 0.9))
    d = erase_draws(key, x.shape, 0.9)
    assert int(d.apply.sum()) >= 5
    got = aug.random_erasing(torch.from_numpy(x), d).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != x).any(axis=(1, 2, 3)).sum() == int(d.apply.sum())


def test_one_hot_and_sampled_draws():
    assert torch.equal(aug.one_hot_labels(torch.tensor([2, 0]), 3),
                       torch.tensor([[0.0, 0, 1], [1, 0, 0]]))
    soft = torch.tensor([[0.2, 0.8]])
    assert torch.equal(aug.one_hot_labels(soft, 2), soft)
    g = lambda: torch.Generator().manual_seed(7)
    a = aug.sample_mix(aug.host_rng(g()), H, W)
    assert a == aug.sample_mix(aug.host_rng(g()), H, W)
    e1, e2 = (aug.sample_random_erasing(g(), (4, H, W, 3), 0.5) for _ in range(2))
    for u, v in zip(e1, e2):
        assert torch.equal(u, v)
    assert bool(((e1.area >= 0.02 * H * W) & (e1.area <= 0.33 * H * W)).all())


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_beta_lambda_distribution(alpha):
    """λ ~ Beta(α, α): mean 1/2, variance 1/(4(2α+1)), over 4000 draws."""
    rng = aug.host_rng(torch.Generator().manual_seed(0))
    lam = np.array([aug.sample_mix(rng, H, W, 0.0, alpha).lam for _ in range(4000)])
    assert abs(lam.mean() - 0.5) < 0.03
    assert abs(lam.var() - 1 / (4 * (2 * alpha + 1))) < 0.015
