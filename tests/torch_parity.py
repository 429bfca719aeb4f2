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

Gradients (tests/test_torch_block_{mlp,attention}_bwd.py) are normalised by
max(1, max|JAX|) first, as tests/test_block_kernels.py:155-158 normalises the
JAX kernels' gradients: elementwise ones (dx) through
``assert_matches_kernel``, reduced and weight gradients to
|port − JAX| ≤ 2e-2 (``assert_reduced_close``).
"""

import numpy as np
import torch

TIGHT = 1e-4
MIN_TIGHT_SHARE = 0.75
BF16_FLIP = 1e-2
REDUCED_TOL = 2e-2


def assert_matches_kernel(got: np.ndarray, want: np.ndarray, tight: float = TIGHT) -> None:
    close = np.isclose(got, want, rtol=tight, atol=tight)
    assert close.mean() >= MIN_TIGHT_SHARE, (
        f"only {close.mean():.1%} of elements within {tight}: max abs diff "
        f"{np.abs(got - want).max():.3g} — a systematic difference, not rounding flips"
    )
    np.testing.assert_allclose(got, want, rtol=BF16_FLIP, atol=BF16_FLIP)


def as_f32(t) -> np.ndarray:
    """A torch tensor or a JAX/numpy array as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _norm(want: np.ndarray) -> float:
    return max(1.0, float(np.abs(want).max()))


def assert_elementwise_close(got, want, what: str) -> None:
    """``assert_matches_kernel`` after normalising both by max(1, max|JAX|)."""
    got, want = as_f32(got), as_f32(want)
    s = _norm(want)
    try:
        assert_matches_kernel(got / s, want / s)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


def assert_reduced_close(got, want, what: str) -> None:
    """|port − JAX| ≤ 2e-2·max(1, max|JAX|) for reduced and weight gradients."""
    got, want = as_f32(got), as_f32(want)
    err = float(np.abs(got - want).max())
    assert err <= REDUCED_TOL * _norm(want), (what, err, _norm(want))
