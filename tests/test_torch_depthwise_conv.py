"""The port's depthwise conv (vision_toolbox_tpu_torch/ops/depthwise_conv.py,
nn/layers.py ``DepthwiseConv``) vs the JAX package's on CPU.

- The plain twin of K9 against the JAX kernel in interpret mode (as
  tests/test_depthwise_conv.py runs it): forward, and dx and dw against
  ``jax.vjp``, for k ∈ {3, 5, 7}, C ∈ {20, 32}, f32 and bf16. Both sum the
  k² taps in f32 with dy outer and dx inner and round once, so f32 is held
  to 1e-5 (XLA may fuse a tap's product and sum); bf16 outputs to
  tests/torch_parity.py's rule (a flipped final rounding is one bf16 ulp).
  dw sums over batch and space in another order: 1e-4 relative in f32, one
  bf16 ulp (``assert_reduced_close``) in bf16.
- The CUDA entries' argument checks, on meta tensors: the types, k and
  batch the kernels refuse (a batch beyond the C interface's int) raise
  before anything reaches the card.
- The modules (``DepthwiseConv``, ``ConvNormAct``'s depthwise branch)
  against the JAX modules, both with the JAX default dispatch (lax conv) and
  with ``use_depthwise_kernel`` patched on. f32 to 1e-5 either way. bf16
  against the lax conv is a standing difference (ROADMAP Queue 3): the port
  rounds K9's f32 tap sum once, XLA's CPU conv rounds its own sum; held to
  rel L2 ≤ 1e-2.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
import torch
from torch_parity import as_f32, assert_matches_kernel, assert_reduced_close

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.depthwise_conv as jdc
from vision_toolbox_tpu.nn import layers as jlayers
from vision_toolbox_tpu_torch.nn import layers
from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import depthwise_conv as dc
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = 1e-5


CHANNELS = {20: slice(0, 20), 32: slice(20, 52)}  # one JAX call covers both channel counts
_JAX_RESULTS: dict = {}


def _inputs(k: int, C: int = 52, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, 9, C)).astype(np.float32)
    w = (rng.standard_normal((k, k, 1, C)) * 0.2).astype(np.float32)
    g = rng.standard_normal((2, 6, 9, C)).astype(np.float32)
    return x, w, g


def _jax_kernel(k: int, dtype: str):
    """The JAX kernel's (out, dx, dw) in interpret mode at k over all 52
    channels (channels are independent, so each channel count's test reads
    its slice), computed once per (k, dtype): interpret mode compiles for
    seconds per shape."""
    if (k, dtype) not in _JAX_RESULTS:
        jdt = DTYPES[dtype][0]
        jx, jw, jg = (jnp.asarray(a, jdt) for a in _inputs(k, seed=k))
        out, vjp = jax.vjp(lambda x_, w_: jdc.depthwise_conv2d(x_, w_, interpret=True), jx, jw)
        _JAX_RESULTS[k, dtype] = (out, *vjp(jg))
    return _JAX_RESULTS[k, dtype]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("C", list(CHANNELS))
@pytest.mark.parametrize("k", [3, 5, 7])
def test_twin_matches_the_jax_kernel(k, C, dtype):
    tdt, sl = DTYPES[dtype][1], CHANNELS[C]
    want, jdx, jdw = (as_f32(a)[..., sl] for a in _jax_kernel(k, dtype))
    x, w, g = (a[..., sl] for a in _inputs(k, seed=k))
    tx, tw = (torch.from_numpy(np.ascontiguousarray(a)).to(tdt).requires_grad_() for a in (x, w))
    got = dc.depthwise_conv2d(tx, tw)
    got.backward(torch.from_numpy(np.ascontiguousarray(g)).to(tdt))
    assert got.dtype == tdt and tx.grad.dtype == tdt and tw.grad.dtype == tdt
    if dtype == "float32":
        for a, b in ((got, want), (tx.grad, jdx)):
            np.testing.assert_allclose(as_f32(a), b, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(as_f32(tw.grad), jdw, rtol=1e-4, atol=1e-4 * np.abs(jdw).max())
    else:
        assert_matches_kernel(as_f32(got), want)
        assert_matches_kernel(as_f32(tx.grad), jdx)
        assert_reduced_close(tw.grad, jdw, "dw")


def test_gate_is_the_kernels_shape_rule():
    for k in (1, 3, 5, 7, 9, 21):
        assert dc.use_depthwise_kernel(k)
    assert not dc.use_depthwise_kernel(4)  # even: no SAME centre
    assert not dc.use_depthwise_kernel(23)  # its weight-gradient tiles exceed 227 KB
    assert not dc.use_depthwise_kernel(3, stride=2)
    assert not dc.use_depthwise_kernel(3, dilation=2)


def test_cpu_tensors_run_the_plain_versions():
    """On CPU tensors the op is the plain version (bit for bit) and autograd
    runs the plain backward; nothing is launched."""
    x, w, g = _inputs(7, 20)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    before = dict(_cuda.LAUNCHES)
    with torch.no_grad():
        assert torch.equal(dc.depthwise_conv2d(tx, tw), dc.depthwise_conv2d_plain(tx, tw))
    x_, w_ = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    dc.depthwise_conv2d(x_, w_).backward(torch.from_numpy(g))
    dx, dw = dc.depthwise_conv2d_bwd_plain(tx, tw, torch.from_numpy(g))
    assert torch.equal(x_.grad, dx) and torch.equal(w_.grad, dw)
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("what,x_shape,w_shape,dtype,error", [
    ("type", (2, 8, 8, 16), (3, 3, 1, 16), torch.float16, TypeError),
    ("even k", (2, 8, 8, 16), (4, 4, 1, 16), torch.bfloat16, ValueError),
    ("k above 21", (2, 8, 8, 16), (23, 23, 1, 16), torch.bfloat16, ValueError),
    ("batch beyond a C int", (2**31, 1, 1, 8), (3, 3, 1, 8), torch.bfloat16, ValueError),
    ("weights of another C", (2, 8, 8, 16), (3, 3, 1, 8), torch.float32, ValueError),
    ("x not NHWC", (8, 8, 16), (3, 3, 1, 16), torch.float32, ValueError),
])
def test_cuda_entries_check_their_arguments(what, x_shape, w_shape, dtype, error):
    """``depthwise_conv2d_cuda``, ``depthwise_conv2d_bwd_cuda`` and
    ``kernel_geometry`` refuse what the kernels do not take before anything
    reaches the card (meta tensors: no data, no launch); the backward also a
    cotangent unlike x."""
    x = torch.empty(x_shape, dtype=dtype, device="meta")
    w = torch.empty(w_shape, dtype=dtype, device="meta")
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(error):
        dc.depthwise_conv2d_cuda(x, w)
    with pytest.raises(error):
        dc.depthwise_conv2d_bwd_cuda(x, w, x)
    with pytest.raises(error):
        dc.kernel_geometry(x, w, bwd=True)
    if what == "type":
        ok = torch.empty(x_shape, dtype=torch.bfloat16, device="meta")
        ok_w = torch.empty(w_shape, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="must match x"):
            dc.depthwise_conv2d_bwd_cuda(ok, ok_w, x)
    assert _cuda.LAUNCHES == before


def _module_pair(kind: str, k: int, C: int, jdt, tdt):
    if kind == "DepthwiseConv":
        jm = jlayers.DepthwiseConv(k, dtype=jdt)
        pm = layers.DepthwiseConv(C, k, dtype=tdt, generator=torch.Generator().manual_seed(0))
    else:  # ConvNormAct's depthwise branch, no norm: conv + bias + relu6 (exact in bf16)
        jm = jlayers.ConvNormAct(C, k, groups=C, norm="none", act="relu6", dtype=jdt)
        pm = layers.ConvNormAct(C, C, k, groups=C, norm="none", act="relu6", dtype=tdt,
                                generator=torch.Generator().manual_seed(0))
        assert pm.depthwise and isinstance(pm.conv, layers.DepthwiseConv)
    return jm, pm


@pytest.mark.parametrize("kernel_on", [False, True], ids=["lax", "k9"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["DepthwiseConv", "ConvNormAct"])
def test_modules_match_jax(monkeypatch, kind, dtype, kernel_on):
    if kernel_on:
        monkeypatch.setattr(jdc, "use_depthwise_kernel", lambda *a: True)
    jdt, tdt = DTYPES[dtype]
    k, C = 7, 32
    x = np.random.default_rng(3).standard_normal((2, 10, 12, C)).astype(np.float32)
    jm, pm = _module_pair(kind, k, C, jdt, tdt)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    pm.load_state_dict(flax_to_state_dict(params), strict=True)
    assert pm.state_dict()[next(n for n in pm.state_dict() if n.endswith("weight"))].shape == (
        C, 1, k, k)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == tdt
    got = as_f32(got)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    elif kernel_on:
        assert_matches_kernel(got, want)
    else:  # the standing difference against the lax conv's own rounding
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_separable_conv_matches_jax():
    """``SeparableConv2d`` (depthwise 3×3 → BN → relu6, pointwise → BN →
    relu6), train and eval, f32."""
    cin, cout = 16, 24
    x = np.random.default_rng(5).standard_normal((2, 9, 9, cin)).astype(np.float32)
    jm = jlayers.SeparableConv2d(cout)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    pm = layers.SeparableConv2d(cin, cout, generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]),
                       strict=True)
    assert isinstance(pm.dw.conv, layers.DepthwiseConv)
    for train in (False, True):
        if train:
            want, _ = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            want = jm.apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = pm(torch.from_numpy(x), train=train)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
