"""The port's TrivialAugmentWide (vision_toolbox_tpu_torch/ops/
trivial_augment.py) vs the JAX package's, given the JAX package's draws.

The JAX side's geometric pass is pointed at its shear3 warp (the TPU kernel
K1 in interpret mode): on CPU its ``affine_warp`` would take the 2-D gather,
while the port's takes the shear3 warp for square images on every device.
Tolerances: ``_equalize`` and the integer ops bit-exact; every op within
max abs 1e-6 (the sharpness blur sums its 3×3 taps in another order;
measured ≤ 1.2e-7).
"""

import numpy as np
import pytest
import torch
from torch_draws import ta_draws

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.warp as jwarp
from vision_toolbox_tpu.ops import trivial_augment as jta
from vision_toolbox_tpu.ops.warp_pallas import shear3_warp_pallas
from vision_toolbox_tpu_torch.ops import trivial_augment as ta
from vision_toolbox_tpu_torch.ops import warp

ATOL = 1e-6


@pytest.fixture
def jax_shear3(monkeypatch):
    monkeypatch.setattr(jwarp, "affine_warp",
                        lambda im, op, mag: shear3_warp_pallas(im, op, mag, interpret=True))


def _levels(shape, seed):
    """Images on the uint8 grid, as the loader ships them."""
    return (np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32) / 255.0)


def _port_apply(x, draws, capacity):
    """``trivial_augment_wide_apply`` with an explicit subset capacity."""
    op = draws.op
    mag01 = draws.mag_idx.float() / 30
    signed = mag01 * draws.sign
    out = warp.affine_warp(torch.from_numpy(x), op, signed)
    return ta._apply_pixel_ops(out, op, mag01, signed, capacity).numpy()


def _jax_apply(x, draws, capacity=None):
    op = jnp.asarray(draws.op.numpy())
    mag01 = jnp.asarray(draws.mag_idx.numpy()).astype(jnp.float32) / 30
    signed = mag01 * jnp.asarray(draws.sign.numpy())
    out = shear3_warp_pallas(jnp.asarray(x), op, signed, interpret=True)
    return np.asarray(jta._apply_pixel_ops(out, op, mag01, signed, capacity))


@pytest.mark.parametrize("op", range(ta.NUM_OPS))
def test_each_op_matches_jax(op):
    x = _levels((4, 16, 16, 3), seed=op)
    draws = ta.TADraws(torch.full((4,), op), torch.tensor([0, 7, 19, 30]),
                       torch.tensor([1.0, -1.0, 1.0, -1.0]))
    got = ta.trivial_augment_wide_apply(torch.from_numpy(x), draws).numpy()
    want = _jax_apply(x, draws)
    if op in (ta.OP_POSTERIZE, ta.OP_SOLARIZE, ta.OP_EQUALIZE, ta.OP_IDENTITY):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_equalize_bit_exact():
    """Integer LUT vs the nibble-matmul LUT: same bits, on uint8-grid images,
    a channel with one level (step 0: unchanged), two levels, a narrow range,
    and off-grid values that round to the grid."""
    x = _levels((5, 16, 16, 3), seed=11)
    x[0, ..., 0] = 0.5
    x[1, ..., 1] = np.where(np.arange(16)[None, :] < 3, 1.0, 0.0)
    x[2] = np.round(x[2] * 20) / 255.0
    x[3] = np.random.default_rng(2).random((16, 16, 3), dtype=np.float32)
    got = ta._equalize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jta._equalize(jnp.asarray(x))))


def test_subset_path_explicit_capacity():
    """Sharpness/equalize on a gathered subset smaller than the batch
    (capacity 8 of 16), with members beyond and within the capacity."""
    x = _levels((16, 16, 16, 3), seed=5)
    op = torch.tensor([9, 13, 0, 6, 9, 1, 13, 13, 2, 9, 5, 12, 10, 11, 7, 8])
    sign = torch.where(torch.arange(16) % 3 == 0, -1.0, 1.0)
    draws = ta.TADraws(op, torch.arange(16) * 2 % 31, sign)
    got = _port_apply(x, draws, capacity=8)
    np.testing.assert_allclose(got, _jax_apply(x, draws, capacity=8), rtol=0, atol=ATOL)


def test_trivial_augment_wide_matches_jax(jax_shear3):
    """End to end from one JAX key at B = 64, 16 px: the default capacity
    (_subset_capacity(64, 2) = 40 < 64) takes the subset path."""
    assert ta._subset_capacity(64, 2) == jta._subset_capacity(64, 2) == 40
    key = jax.random.PRNGKey(3)
    x = _levels((64, 16, 16, 3), seed=9)
    want = np.asarray(jta.trivial_augment_wide(key, jnp.asarray(x)))
    got = ta.trivial_augment_wide_apply(torch.from_numpy(x), ta_draws(key, 64)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_sampled_draws_are_seeded_and_in_range():
    a = ta.sample_trivial_augment(torch.Generator().manual_seed(1), 512)
    b = ta.sample_trivial_augment(torch.Generator().manual_seed(1), 512)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert set(a.op.tolist()) == set(range(ta.NUM_OPS))
    assert a.mag_idx.min() >= 0 and a.mag_idx.max() == 30
    assert set(a.sign.tolist()) == {-1.0, 1.0}
    x = torch.rand(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    out = ta.trivial_augment_wide(torch.Generator().manual_seed(2), x)
    assert out.shape == x.shape and bool(((out >= 0) & (out <= 1)).all())
