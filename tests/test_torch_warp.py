"""The port's three-shear warp (vision_toolbox_tpu_torch/ops/warp.py) vs the
JAX package's: the plain version against ``shear3_warp_xla`` and against
the TPU kernel K1 (``shear3_warp_pallas``) in interpret mode, the 2-D
gather against ``_affine_warp``, and the ``affine_warp`` dispatch. K1's
staged footprints are held in ``tests/test_torch_warp_footprint_*.py``
(``tests/torch_warp_footprint.py``).

Inputs are numpy images in [0, 1]. Tolerance: max abs error ≤ 1e-6. The
port forms every intermediate with the same f32 operations (measured: 0
against the XLA version, ≤ 2.4e-7 against the Pallas kernel, whose f32 sums
differ by an ulp).
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_toolbox_tpu.ops import trivial_augment as jta
from vision_toolbox_tpu.ops.warp import shear3_params as jax_shear3_params
from vision_toolbox_tpu.ops.warp import shear3_warp_xla
from vision_toolbox_tpu.ops.warp_pallas import shear3_warp_pallas
from vision_toolbox_tpu_torch.ops import trivial_augment as ta
from vision_toolbox_tpu_torch.ops import warp

ATOL = 1e-6

CASES = [
    (ta.OP_IDENTITY, 0.3),
    (ta.OP_SHEAR_X, 0.5),
    (ta.OP_SHEAR_X, -0.8),
    (ta.OP_SHEAR_Y, 0.6),
    (ta.OP_SHEAR_Y, -1.0),
    (ta.OP_TRANSLATE_X, 0.4),
    (ta.OP_TRANSLATE_Y, -0.9),
    (ta.OP_ROTATE, 1.0),  # +135°: k90 = +1
    (ta.OP_ROTATE, -1.0),  # −135°: k90 = −1
    (ta.OP_ROTATE, 0.3),  # 40.5°: k90 = 0
    (ta.OP_ROTATE, -1 / 3),  # −45°: k90 = 0 at the boundary
    (ta.OP_ROTATE, 2 / 3),  # 90°
    (ta.OP_SOLARIZE, 0.5),  # pixel op: identity warp
]


def _images(b, s=32, seed=0):
    return np.random.default_rng(seed).random((b, s, s, 3), dtype=np.float32)


def _port(x, op, mag):
    out = warp.shear3_warp(torch.from_numpy(x), torch.from_numpy(op), torch.from_numpy(mag))
    return out.numpy()


@pytest.mark.parametrize("op,mag", CASES)
def test_plain_matches_jax_xla_and_pallas(op, mag):
    x = _images(2, seed=op)
    ops = np.full(2, op, np.int32)
    mags = np.array([mag, -mag], np.float32)
    got = _port(x, ops, mags)
    args = (jnp.asarray(x), jnp.asarray(ops), jnp.asarray(mags))
    np.testing.assert_allclose(got, np.asarray(shear3_warp_xla(*args)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(shear3_warp_pallas(*args, interpret=True)),
                               rtol=0, atol=ATOL)


def test_mixed_batch_matches_pallas():
    """All 14 ops in one batch at 40 px (canvas 128), random signed magnitudes."""
    rng = np.random.default_rng(7)
    x = _images(14, s=40, seed=1)
    ops = rng.permutation(14).astype(np.int32)
    mags = rng.uniform(-1, 1, 14).astype(np.float32)
    got = _port(x, ops, mags)
    want = shear3_warp_pallas(jnp.asarray(x), jnp.asarray(ops), jnp.asarray(mags), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_shear3_params_match_jax():
    ops = np.repeat(np.arange(14, dtype=np.int32), 3)
    mags = np.tile(np.array([-1.0, 0.37, 1.0], np.float32), 14)
    got = warp.shear3_params(torch.from_numpy(ops), torch.from_numpy(mags))
    want = jax_shear3_params(jnp.asarray(ops), jnp.asarray(mags))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_gather_matches_jax():
    """``_affine_warp``, the exact 2-D bilinear gather, on a non-square batch."""
    rng = np.random.default_rng(3)
    x = rng.random((14, 24, 40, 3), dtype=np.float32)
    ops = np.arange(14, dtype=np.int32)
    mags = rng.uniform(-1, 1, 14).astype(np.float32)
    got = ta._affine_warp(torch.from_numpy(x), torch.from_numpy(ops), torch.from_numpy(mags))
    want = jta._affine_warp(jnp.asarray(x), jnp.asarray(ops), jnp.asarray(mags))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_affine_warp_dispatch_by_shape():
    """Square images take the three-shear warp, others the gather, on CPU
    as on the card."""
    ops = torch.tensor([ta.OP_ROTATE, ta.OP_SHEAR_X], dtype=torch.int32)
    mags = torch.tensor([0.3, -0.6])
    sq = torch.from_numpy(_images(2, s=24))
    program = warp.shear3_params(ops, mags)
    assert torch.equal(warp.affine_warp(sq, ops, mags), warp.shear3_warp_plain(sq, program))
    rect = torch.from_numpy(np.random.default_rng(4).random((2, 16, 24, 3), dtype=np.float32))
    assert torch.equal(warp.affine_warp(rect, ops, mags), ta._affine_warp(rect, ops, mags))
    assert not torch.allclose(warp.affine_warp(sq, ops, mags), ta._affine_warp(sq, ops, mags),
                              atol=1e-3)  # a rotation's 3 passes are not the 2-D gather


def test_identity_program_is_exact_copy():
    x = _images(3, s=16)
    ops = np.array([ta.OP_IDENTITY, ta.OP_EQUALIZE, ta.OP_BRIGHTNESS], np.int32)
    np.testing.assert_array_equal(_port(x, ops, np.array([0.5, -1.0, 1.0], np.float32)), x)


def test_canvas_size_matches_pallas():
    from vision_toolbox_tpu.ops.warp_pallas import canvas_size

    for h in (16, 32, 64, 176, 224, 256):
        assert warp.canvas_size(h) == canvas_size(h)
    assert warp.canvas_size(176) == 512
