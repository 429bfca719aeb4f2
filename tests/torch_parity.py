"""Comparison helper for the port's plain kernel versions vs the JAX kernels.

Both sides round at the same points (bf16 y/q/k/v/p/o/h/g, f32
accumulation), but torch and XLA sum in different orders. Where the order
moves an f32 value across a bf16 rounding boundary, the two differ there by
one bf16 ulp, and that shows in the output as up to a few 1e-3 (measured:
at most 4.7e-3 over 30 seeds at the test shapes, on up to 11.7% of the
elements, all rows of the image behind a flipped key or value). So most
elements are held to the JAX kernels' own forward tolerance and every
element to the one the JAX tests use when only the accumulation order
differs:

- at least 3/4 of the elements within rtol = atol = 1e-4
  (tests/test_block_kernels.py:103, :189) — a wrong rounding point, GELU or
  scale moves nearly every element past that;
- all elements within rtol = atol = 1e-2 (tests/test_block_kernels.py:583-586).
"""

import numpy as np

TIGHT = 1e-4
MIN_TIGHT_SHARE = 0.75
BF16_FLIP = 1e-2


def assert_matches_kernel(got: np.ndarray, want: np.ndarray, tight: float = TIGHT) -> None:
    close = np.isclose(got, want, rtol=tight, atol=tight)
    assert close.mean() >= MIN_TIGHT_SHARE, (
        f"only {close.mean():.1%} of elements within {tight}: max abs diff "
        f"{np.abs(got - want).max():.3g} — a systematic difference, not rounding flips"
    )
    np.testing.assert_allclose(got, want, rtol=BF16_FLIP, atol=BF16_FLIP)
