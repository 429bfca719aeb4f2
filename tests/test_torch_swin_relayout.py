"""The port's shifted-window relayout (vision_toolbox_tpu_torch/ops/swin_relayout.py,
K8) vs the JAX kernels (vision_toolbox_tpu/ops/swin_relayout.py) in interpret
mode.

Both directions are permutations, so the plain PyTorch versions (what the
port runs on CPU tensors and holds its CUDA kernels against on the card)
must equal the JAX kernels bit for bit, in f32 and bf16, for windows 4 and
7 and shifts 0, 2 and 3, and so must the gradients: each direction's VJP is
the other direction. Inputs are made from a seed with numpy and fed to both.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.swin_relayout as jsr
from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import swin_relayout as sr

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (H, W, w, shift): windows 4 and 7, shifts 0, 2 and 3, a map that is not square
CASES = [(8, 8, 4, 0), (8, 12, 4, 2), (12, 8, 4, 3), (14, 14, 7, 0), (14, 14, 7, 2),
         (14, 21, 7, 3)]


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _both(shape, dtype, seed):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,w,s", CASES)
def test_partition_and_its_vjp_match_jax(dtype, H, W, w, s):
    jx, tx = _both((2, H, W, 6), dtype, H * W + s)
    nwin = (H // w) * (W // w)
    jg, tg = _both((2, nwin, w * w, 6), dtype, H * W + s + 1)
    want, vjp = jax.vjp(lambda x: jsr.shifted_window_partition(x, w, s, True), jx)
    tx = tx.requires_grad_()
    got = sr.shifted_window_partition(tx, w, s)
    got.backward(tg)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(got.detach().float().numpy(), _np(want))
    np.testing.assert_array_equal(tx.grad.float().numpy(), _np(vjp(jg)[0]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,w,s", CASES)
def test_unpartition_and_its_vjp_match_jax(dtype, H, W, w, s):
    nwin = (H // w) * (W // w)
    jy, ty = _both((2, nwin, w * w, 6), dtype, H * W + s + 2)
    jg, tg = _both((2, H, W, 6), dtype, H * W + s + 3)
    want, vjp = jax.vjp(lambda y: jsr.shifted_window_unpartition(y, w, s, H, W, True), jy)
    ty = ty.requires_grad_()
    got = sr.shifted_window_unpartition(ty, w, s, H, W)
    got.backward(tg)
    np.testing.assert_array_equal(got.detach().float().numpy(), _np(want))
    np.testing.assert_array_equal(ty.grad.float().numpy(), _np(vjp(jg)[0]))


@pytest.mark.parametrize("w,s", [(4, 2), (7, 3)])
def test_round_trip_and_the_served_ops(w, s):
    """Unpartition undoes partition; without gradients the entry points run
    the registered custom ops, which on CPU tensors are the plain versions
    and launch no kernel."""
    x = torch.randn(3, 2 * w, 3 * w, 5, generator=torch.Generator().manual_seed(w))
    before = dict(_cuda.LAUNCHES)
    with torch.no_grad():
        y = sr.shifted_window_partition(x, w, s)
        back = sr.shifted_window_unpartition(y, w, s, 2 * w, 3 * w)
    assert torch.equal(back, x)
    assert torch.equal(y, torch.ops.vtt.swin_window_partition(x, w, s))
    assert torch.equal(back, torch.ops.vtt.swin_window_unpartition(y, w, s, 2 * w, 3 * w))
    assert torch.equal(y, sr.window_partition(torch.roll(x, (-s, -s), (1, 2)), w))
    assert _cuda.LAUNCHES == before


def test_dispatch_rule():
    """The kernels run at every shifted block; unshifted blocks keep the
    plain reshape/permute, as the JAX package does outside its kernel."""
    assert sr.use_swin_relayout(3) and sr.use_swin_relayout(1)
    assert not sr.use_swin_relayout(0)
