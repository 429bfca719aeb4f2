"""The port's short-sequence attention (vision_toolbox_tpu_torch/ops/
short_attention.py, K2) vs the JAX package's on CPU.

- The plain pair of K2 (forward, and the backward through
  ``ShortAttentionFunction``) against the JAX kernels in interpret mode, as
  tests/test_short_attention.py runs them: ``short_attention_packed`` at
  cross attention (T = 12, S = 20, head 40) and self attention (T = S = 17,
  head 16), and the flat ``short_attention`` at the first, f32 and bf16,
  each at 64 (batch·head) pairs. Both sides form the same f32 values and
  round once, so f32 is held to 1e-5 (summation order) and bf16 to one bf16
  ulp (rtol 2⁻⁷; atol 1e-6 for the values that round to zero). One JAX call
  per (entry, case, dtype) gives the output and the VJP.
- ``use_short`` against the JAX rule's shape terms.
- The custom op ``vtt::short_attention``: its registration (``opcheck``),
  and its run-time pair test (K2 from 64 pairs, ``dense_attention`` below).
- The standing difference from the JAX package's default CPU path: at K2's
  shapes the port runs K2's rounding (p in f32) on every device, where JAX
  on a CPU runs ``jax.nn.dot_product_attention`` (p rounded to v's type).
  In f32 the two agree to summation order; in bf16 they differ by p's
  rounding, held to rel L2 ≤ 1e-2.
- The second-plane controls, bf16: ``dense_attention`` (p rounded to bf16
  once) and ``short_attention_bwd_one_plane`` (p and ds rounded once) lie at
  least twice as far (rel L2) from the JAX kernel as the plain twins, the
  rule the card holds the kernels to against the same controls.
- The CUDA entries' argument checks, on meta tensors: they raise before
  any launch.
"""

import numpy as np
import pytest
import torch
from torch_parity import as_f32

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.short_attention as jsa
from vision_toolbox_tpu.ops.attention import dot_product_attention as jax_attention
from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import short_attention as sa

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = 1e-5
BF16_ULP = 2.0**-7
# (B, T, S, N, H): 64 pairs each
CASES = {"cross_h40": (8, 12, 20, 8, 40), "self_h16": (4, 17, 17, 16, 16)}
ENTRIES = {"packed": jsa.short_attention_packed, "flat": jsa.short_attention}
_JAX_RESULTS: dict = {}


def _inputs(case: str):
    B, T, S, N, H = CASES[case]
    rng = np.random.default_rng(T * S + H)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, T, N, H), f(B, S, N, H), f(B, S, N, H), f(B, T, N, H)


def _jax_kernel(entry: str, case: str, dtype: str):
    """The JAX kernel's (out, dq, dk, dv) in interpret mode, once per
    (entry, case, dtype)."""
    key = (entry, case, dtype)
    if key not in _JAX_RESULTS:
        jdt = DTYPES[dtype][0]
        q, k, v, g = (jnp.asarray(a, jdt) for a in _inputs(case))
        fn = lambda q_, k_, v_: ENTRIES[entry](q_, k_, v_, interpret=True)
        out, vjp = jax.vjp(fn, q, k, v)
        _JAX_RESULTS[key] = tuple(as_f32(a) for a in (out, *vjp(g)))
    return _JAX_RESULTS[key]


def _assert_close(got: np.ndarray, want: np.ndarray, dtype: str, what: str) -> None:
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("entry,case", [("packed", "cross_h40"), ("packed", "self_h16"),
                                        ("flat", "cross_h40")])
def test_plain_pair_matches_the_jax_kernel(entry, case, dtype):
    tdt = DTYPES[dtype][1]
    want = _jax_kernel(entry, case, dtype)
    q, k, v, g = (torch.from_numpy(a).to(tdt).requires_grad_() for a in _inputs(case))
    port_entry = {"packed": sa.short_attention_packed, "flat": sa.short_attention}[entry]
    before = dict(_cuda.LAUNCHES)
    out = port_entry(q, k, v)
    assert type(out.grad_fn).__name__ == "ShortAttentionFunctionBackward"
    out.backward(g.detach())
    assert _cuda.LAUNCHES == before  # CPU tensors: the plain versions, no launch
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, q.grad, k.grad, v.grad), want):
        assert a.dtype == tdt, name
        _assert_close(as_f32(a), b, dtype, name)


def test_backward_saves_only_q_k_v():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_() for a in _inputs("self_h16"))
    out = sa.short_attention_packed(q, k, v)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(s is t for s, t in zip(saved, (q, k, v)))


def test_use_short_matches_the_jax_rule(monkeypatch):
    """Every shape term of the JAX rule, on either side of each bound; the
    JAX rule asked as on a TPU."""
    monkeypatch.setattr(jsa.jax, "default_backend", lambda: "tpu")
    for t in (1, 2, 197, 512, 513):
        for s in (1, 2, 50, 512, 513):
            for h in (16, 40, 80, 128, 136):
                for pairs in (12, 63, 64, 1536):
                    assert sa.use_short(t, s, h, pairs) == jsa.use_short(t, s, h, pairs), \
                        (t, s, h, pairs)
                    assert sa.short_shape(t, s, h) == jsa.use_short(t, s, h, 64)


def test_op_registration():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs("self_h16"))
    torch.library.opcheck(sa._short_attention_op, (q, k, v))
    torch.library.opcheck(sa._short_attention_op, (q[:1], k[:1], v[:1]))  # 16 pairs: dense


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_op_takes_the_pair_test_at_run_time(dtype):
    """The op runs K2 from 64 (batch·head) pairs and ``dense_attention``
    (``jax.nn.dot_product_attention``'s rounding) below, as the JAX
    dispatch does; the entry without gradients runs the op, and with
    ``plain=True`` the same branches."""
    tdt = DTYPES[dtype][1]
    q, k, v, _ = (torch.from_numpy(a).to(tdt) for a in _inputs("self_h16"))  # B = 4, N = 16
    for b, k2 in ((4, True), (3, False), (1, False)):
        args = (q[:b], k[:b], v[:b])
        want = (sa.short_attention_plain if k2 else sa.dense_attention)(*args)
        assert torch.equal(torch.ops.vtt.short_attention(*args), want), b
        with torch.no_grad():
            assert torch.equal(sa.short_attention_packed(*args), want), b
            assert torch.equal(sa.short_attention_packed(*args, plain=True), want), b


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_standing_difference_from_jax_default_path(dtype):
    """At K2's shapes the port rounds as K2 does on every device; JAX on a
    CPU runs ``jax.nn.dot_product_attention``, which rounds p to v's type
    (ROADMAP Queue 3). f32: summation order only; bf16: p's rounding,
    within rel L2 1e-2 and not bit-equal."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, _ = _inputs("self_h16")
    want = as_f32(jax_attention(*(jnp.asarray(a, jdt) for a in (q, k, v))))
    with torch.no_grad():
        got = as_f32(sa.short_attention_packed(*(torch.from_numpy(a).to(tdt) for a in (q, k, v))))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
        assert not np.array_equal(got, want)


def _rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.linalg.norm(as_f32(got) - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", list(CASES))
def test_second_plane_controls_lie_farther_from_the_jax_kernel(case):
    """bf16: the forward's control ``dense_attention`` (p rounded to bf16
    once before p·v) and the backward's ``short_attention_bwd_one_plane``
    (p rounded before dv, ds before dq and dk) against the JAX kernel in
    interpret mode: the plain twins lie at most half as far (rel L2), the
    rule that lets the card's control refuse a kernel that drops p's or ds's
    second plane (measured: twins ≤ 6e-5, controls ≥ 2.5e-3)."""
    want = _jax_kernel("packed", case, "bfloat16")
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(case))
    twin = (sa.short_attention_plain(q, k, v), *sa.short_attention_bwd_plain(q, k, v, g))
    control = (sa.dense_attention(q, k, v), *sa.short_attention_bwd_one_plane(q, k, v, g))
    for name, a, b, w in zip(("out", "dq", "dk", "dv"), twin, control, want):
        assert _rel_l2(a, w) <= 0.5 * _rel_l2(b, w), name


@pytest.mark.parametrize("what,shapes,dtype,error", [
    ("type", ((8, 17, 8, 16), (8, 17, 8, 16)), torch.float16, TypeError),
    ("head above 128", ((1, 17, 64, 136), (1, 17, 64, 136)), torch.bfloat16, ValueError),
    ("T above 512", ((1, 513, 64, 64), (1, 17, 64, 64)), torch.bfloat16, ValueError),
    ("S above 512", ((1, 17, 64, 64), (1, 513, 64, 64)), torch.bfloat16, ValueError),
    ("mismatched heads", ((8, 17, 8, 16), (8, 17, 4, 16)), torch.bfloat16, ValueError),
])
def test_cuda_entries_check_their_arguments(what, shapes, dtype, error):
    """``short_attention_cuda`` and ``short_attention_bwd_cuda`` refuse what
    the kernels do not take before anything reaches the card (meta
    tensors: no data, no launch); the backward also a cotangent unlike q."""
    (qs, ks) = shapes
    q = torch.empty(qs, dtype=dtype, device="meta")
    k = v = torch.empty(ks, dtype=dtype, device="meta")
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(error):
        sa.short_attention_cuda(q, k, v)
    with pytest.raises(error):
        sa.short_attention_bwd_cuda(q, k, v, q)
    if what == "type":
        ok = torch.empty(qs, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="must match q"):
            sa.short_attention_bwd_cuda(ok, ok, ok, q)
    assert _cuda.LAUNCHES == before
