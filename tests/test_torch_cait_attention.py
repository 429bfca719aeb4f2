"""The port's talking-head attention (vision_toolbox_tpu_torch/ops/
cait_attention.py) vs the JAX package's Pallas kernel K5 in interpret mode.

Both compute every intermediate in f32 from the inputs as given (the
kernel's rounding), so in f32 only the order of f32 sums differs: the
forward is held to the JAX kernel test's 2e-5 and the gradients of all
seven inputs to its 2e-4 (tests/test_cait_attention_kernel.py). With bf16
q/k/v both round the output once to bf16, and a summation-order flip moves
an element by one bf16 ulp: held by tests/torch_parity.py's rule.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import assert_matches_kernel

from vision_toolbox_tpu.ops.cait_attention import talking_head_attention as jax_talking_head
from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import cait_attention as ca

# (B, T, S, heads, head width): the JAX kernel test's shapes and its T ≠ S case
SHAPES = [(3, 24, 24, 4, 48), (2, 16, 16, 8, 48), (2, 40, 40, 4, 64), (2, 8, 24, 4, 48)]


def _inputs(B, T, S, H, hd, seed=0):
    """q, k, v, ml, mlb, mw, mwb and a cotangent, f32 numpy (mixes near the
    identity, small biases, as the JAX kernel test draws them)."""
    rng = np.random.default_rng(seed)
    D = H * hd
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    eye = np.eye(H, dtype=np.float32)
    args = (r(B, T, D), r(B, S, D), r(B, S, D), 0.3 * r(H, H) + eye, 0.1 * r(H),
            0.3 * r(H, H) + eye, 0.1 * r(H))
    return args, r(B, T, D)


def _jax(args, dtype=jnp.float32):
    q, k, v, *mixes = (jnp.asarray(a) for a in args)
    return jax_talking_head(q.astype(dtype), k.astype(dtype), v.astype(dtype), *mixes,
                            interpret=True)


@pytest.mark.parametrize("B,T,S,H,hd", SHAPES)
def test_plain_forward_matches_jax_f32(B, T, S, H, hd):
    args, _ = _inputs(B, T, S, H, hd)
    want = np.asarray(_jax(args))
    got = ca.talking_head_plain(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == (B, T, H * hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,T,S,H,hd", SHAPES)
def test_plain_forward_matches_jax_bf16(B, T, S, H, hd):
    args, _ = _inputs(B, T, S, H, hd, seed=1)
    want = np.asarray(_jax(args, jnp.bfloat16).astype(jnp.float32))
    t = [torch.from_numpy(a) for a in args]
    got = ca.talking_head_plain(*(x.bfloat16() for x in t[:3]), *t[3:])
    assert got.dtype == torch.bfloat16
    assert_matches_kernel(got.float().numpy(), want)


@pytest.mark.parametrize("B,T,S,H,hd", [SHAPES[0], SHAPES[3]])
def test_autograd_matches_jax_grad(B, T, S, H, hd):
    """``talking_head_attention`` under autograd (the plain backward on CPU
    tensors) vs ``jax.grad`` through the interpret-mode kernel, for q, k, v
    and the four mix parameters. The pre-softmax bias's gradient is zero in
    exact arithmetic (it shifts whole softmax rows): both sides return
    f32 noise within the same 2e-4."""
    args, co = _inputs(B, T, S, H, hd, seed=2)

    def loss(*a):
        return jnp.sum(jnp.asarray(co) * jax_talking_head(*a, interpret=True))

    want = jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    (ca.talking_head_attention(*leaves) * torch.from_numpy(co)).sum().backward()
    for name, w, t in zip(("q", "k", "v", "ml", "mlb", "mw", "mwb"), want, leaves):
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_bf16_backward_rounds_once_to_the_input_type():
    """bf16 q/k/v: dq, dk, dv come back in bf16 and equal the f32 backward
    on the same (bf16-exact) inputs rounded once; the mix gradients stay
    f32 and equal it."""
    args, co = _inputs(2, 24, 24, 4, 48, seed=3)
    t = [torch.from_numpy(a) for a in args]
    qkv = [x.bfloat16() for x in t[:3]]
    dout = torch.from_numpy(co).bfloat16()
    got = ca.talking_head_bwd_plain(*qkv, *t[3:], dout)
    want = ca.talking_head_bwd_plain(*(x.float() for x in qkv), *t[3:], dout.float())
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w.bfloat16())
    for g, w in zip(got[3], want[3]):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_custom_op_runs_the_plain_version_on_cpu():
    """Without gradients the entry point runs the registered op
    ``vtt::talking_head_attention``; on CPU tensors that is the plain
    version, and it launches no kernel."""
    args, _ = _inputs(2, 16, 16, 8, 48, seed=4)
    t = [torch.from_numpy(a) for a in args]
    before = dict(_cuda.LAUNCHES)
    with torch.no_grad():
        got = ca.talking_head_attention(*t)
    assert torch.equal(got, torch.ops.vtt.talking_head_attention(*t))
    assert torch.equal(got, ca.talking_head_plain(*t))
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("t,s,heads,hd,admitted", [
    (196, 196, 8, 48, True),    # cait_s_24 at 224 px
    (196, 196, 4, 48, True),    # cait_xxs_*
    (196, 196, 6, 48, True),    # cait_xs_24
    (196, 196, 16, 48, True),   # cait_m_*: the JAX gate's 14.7 MB refuses it
    (576, 576, 8, 48, False),   # 384 px: T > 512
    (512, 512, 16, 48, False),  # beyond the JAX rule's VMEM budget, and no 4-row block fits
    (196, 196, 8, 32, True),    # any head width: zero-padded to a multiple of 16
    (24, 72, 4, 64, True),
    (64, 512, 16, 48, True),    # the JAX rule's corner: backward blocks of two query rows
    (40, 40, 4, 160, True),     # wider than 128: the logits in two 80-column chunks
    (196, 196, 17, 48, False),  # more than 16 heads
])
def test_gate_is_the_kernels_shape_rule(t, s, heads, hd, admitted):
    assert ca.use_talking_head_kernel(t, s, heads, hd) is admitted


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _refused(case: str):
    """(q, k, v, ml, mlb, mw, mwb, dout) for one thing the CUDA kernels do not
    take, on meta tensors (no data, no card): the checks run before any
    launch."""
    B, T, S, H, hd = 2, 40, 56, 4, 48
    if case == "17 heads":
        H = 17
    if case == "T above 512":
        T = 513
    q, k, v, dout = _meta(B, T, H * hd), _meta(B, S, H * hd), _meta(B, S, H * hd), _meta(B, T, H * hd)
    mixes = [_meta(H, H, dtype=torch.float32), _meta(H, dtype=torch.float32)] * 2
    if case == "float16":
        q, k, v, dout = (t.half() for t in (q, k, v, dout))
    elif case == "mixed types":
        k = k.float()
    elif case == "k and v differ":
        v = _meta(B, S + 1, H * hd)
    elif case == "batch differs":
        k, v = _meta(B + 1, S, H * hd), _meta(B + 1, S, H * hd)
    elif case == "width not a multiple of the heads":
        q, k, v, dout = (t[..., :-1] for t in (q, k, v, dout))
    elif case == "dout differs":
        dout = _meta(B, T + 1, H * hd)
    return (q, k, v, *mixes), dout


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("mixed types", TypeError), ("k and v differ", ValueError),
    ("batch differs", ValueError), ("width not a multiple of the heads", ValueError),
    ("17 heads", ValueError), ("T above 512", ValueError), ("dout differs", ValueError),
])
def test_cuda_entries_refuse_what_the_kernels_do_not_take(case, error):
    """``talking_head_cuda`` and ``talking_head_bwd_cuda`` raise on a type
    other than f32/bf16 or mixed types, mismatched shapes, a width the
    heads do not divide, a shape outside the gate (more than 16 heads,
    T > 512) and, in the backward, a cotangent unlike q; nothing reaches the
    library and no launch is counted."""
    args, dout = _refused(case)
    before = dict(_cuda.LAUNCHES)
    if case != "dout differs":
        with pytest.raises(error):
            ca.talking_head_cuda(*args)
    with pytest.raises(error):
        ca.talking_head_bwd_cuda(*args, dout)
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("s,heads,hd,kb", [(196, 16, 48, 161.1), (512, 8, 64, 200.6),
                                          (72, 4, 160, 14.7)])
def test_shape_term_counts_the_first_designs_four_row_block(s, heads, hd, kb):
    """The gate's shape term (the first design's backward block of four
    query rows: three f32 score planes, four rows of a head chunk, the
    mixes) in KB, which keeps the admitted set as it was."""
    assert round(ca._shape_term_bytes(s, heads, hd) / 1024, 1) == kb
