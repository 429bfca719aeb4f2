"""Port K4 backward (vision_toolbox_tpu_torch/ops/block_attention.py) vs the
JAX kernels.

The port's plain save-forward and plain backward get the same numpy inputs
and output cotangent as JAX ``_fused_attn_fwd`` / ``_fused_attn_bwd`` in
interpret mode (weights bf16, as ``fused_attention_block`` hands them to the
kernel). Every save (xhat, rstd, q, k, v, o, the probabilities p, proj) and
every gradient is compared, with the tolerances of
tests/test_torch_block_mlp_bwd.py: elementwise tensors through
``assert_matches_kernel`` normalised by max(1, max|JAX|), reduced and weight
gradients to |port − JAX| ≤ 2e-2·max(1, max|JAX|). Then ``torch.autograd``
through the public op is held against ``jax.grad``, and the op without
gradients is shown to run the inference op.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import as_f32, assert_elementwise_close, assert_reduced_close

import vision_toolbox_tpu.ops.block_attention as ba
from vision_toolbox_tpu_torch.ops import block_attention as port

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_W = ("wq", "wk", "wv", "wo")
_B = ("bq", "bk", "bv", "bo")


def _args(B, T, D=128, H=4, seed=0, ls=True, dp=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    a = {"x": f(B, T, D), "H": H, "lns": 1.0 + 0.1 * f(D), "lnb": 0.1 * f(D)}
    for w, b in zip(_W, _B):
        a[w], a[b] = f(D, D) * D**-0.5, 0.1 * f(D)
    a["ls"] = 0.5 + 0.2 * f(D) if ls else None
    a["dp"] = ((rng.random((B, 1)) < 0.7) / 0.7).astype(np.float32) if dp else None
    a["dout"] = f(B, T, D)
    return a


def _jax_fwd_bwd(a, jdt):
    """JAX ``_fused_attn_fwd`` then ``_fused_attn_bwd`` (interpret mode)."""
    j = lambda v, dt=jdt: jnp.asarray(v).astype(dt)
    has_ls = a["ls"] is not None
    B, T, D = a["x"].shape
    ls = j(a["ls"]) if has_ls else jnp.ones((D,), jnp.float32)
    dp = j(a["dp"], jnp.float32) if a["dp"] is not None else jnp.ones((B, 1), jnp.float32)
    x = j(a["x"])
    wb = [j(a[n], jnp.bfloat16) if n in _W else j(a[n]) for pair in zip(_W, _B) for n in pair]
    out, saved = ba._fused_attn_fwd(x, j(a["lns"]), j(a["lnb"]), *wb, ls, dp, x, a["H"], 1,
                                    has_ls, False, True, 1e-6)
    grads = ba._fused_attn_bwd(a["H"], 1, has_ls, False, True, 1e-6, saved, j(a["dout"]))
    return out, saved[:7] + (saved[-1],), grads


def _port_fwd_bwd(a, tdt):
    t = lambda v, dt=tdt: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).to(dt)
    wb = [t(a[n].T, torch.bfloat16) if n in _W else t(a[n]) for pair in zip(_W, _B) for n in pair]
    ls, dp = t(a["ls"]), t(a["dp"], torch.float32)
    ln = [t(a["lns"]), t(a["lnb"])]
    out, saves = port.fused_attention_save_plain(t(a["x"]), *ln, *wb, a["H"], ls, dp, 1e-6)
    grads = port.fused_attention_vjp(t(a["dout"]), saves, *ln, *wb, a["H"], ls, dp)
    return out, saves, grads


CASES = [  # (T, H, ls, dp, dtype)
    (11, 4, True, True, "float32"),
    (17, 2, False, False, "float32"),
    (50, 4, True, False, "float32"),
    (17, 4, False, True, "bfloat16"),
    (50, 2, True, True, "bfloat16"),
]


@pytest.mark.parametrize("T,H,ls,dp,dtype", CASES)
def test_plain_save_forward_and_backward_match_jax_kernels(T, H, ls, dp, dtype):
    a = _args(B=2, T=T, H=H, seed=T + H, ls=ls, dp=dp)
    jdt, tdt = DTYPES[dtype]
    j_out, j_saves, j_grads = _jax_fwd_bwd(a, jdt)
    p_out, p_saves, p_grads = _port_fwd_bwd(a, tdt)

    assert p_out.dtype == tdt and p_grads[0].dtype == tdt
    assert_elementwise_close(as_f32(p_out), as_f32(j_out), "out")
    names = ("xhat", "rstd", "q", "k", "v", "o", "p", "proj")
    for name, got, want in zip(names, p_saves, j_saves):
        if want is None:
            assert got is None, name
            continue
        assert_elementwise_close(as_f32(got), as_f32(want).reshape(got.shape), name)

    *p_rest, p_dls = p_grads
    *j_rest, j_dls, _, _ = j_grads
    assert_elementwise_close(as_f32(p_rest[0]), as_f32(j_rest[0]), "dx")
    grad_names = ("dγ_ln", "dβ_ln", "dWq", "dbq", "dWk", "dbk", "dWv", "dbv", "dWo", "dbo")
    for name, got, want in zip(grad_names, p_rest[1:], j_rest[1:]):
        want = as_f32(want)
        if name.startswith("dW"):
            assert got.dtype == torch.bfloat16, name  # the kernel's weight type
            want = want.T
        else:
            assert got.dtype == tdt, name
        assert_reduced_close(as_f32(got), want, name)
    if ls:
        assert_reduced_close(as_f32(p_dls), as_f32(j_dls), "dγ_ls")
    else:
        assert p_dls is None


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_through_the_op_matches_jax_grad(dtype):
    """``loss = Σ out·w`` through the public ops on both sides: torch.autograd
    on the CPU against jax.grad through the Pallas kernels in interpret mode;
    f32 parameters, rounded by the ops as a model's are."""
    jdt, tdt = DTYPES[dtype]
    a = _args(B=2, T=17, H=4, seed=5, ls=True, dp=True)
    names = ["x", "lns", "lnb", *(n for pair in zip(_W, _B) for n in pair), "ls"]

    def jloss(x, lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo, ls):
        c = lambda v: v.astype(jdt)
        out = ba.fused_attention_block(c(x), c(lns), c(lnb), wq, c(bq), wk, c(bk), wv, c(bv), wo,
                                       c(bo), a["H"], c(ls), jnp.asarray(a["dp"]), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(a["dout"]))

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(*(jnp.asarray(a[n]) for n in names))
    ts = {n: torch.from_numpy(np.ascontiguousarray(a[n])).requires_grad_() for n in names}
    c = lambda v: v.to(tdt)
    wb = [ts[n].t() if n in _W else c(ts[n]) for pair in zip(_W, _B) for n in pair]
    out = port.fused_attention_block(c(ts["x"]), c(ts["lns"]), c(ts["lnb"]), *wb, a["H"],
                                     c(ts["ls"]), torch.from_numpy(a["dp"]))
    (out.float() * torch.from_numpy(a["dout"])).sum().backward()
    for n, w in zip(names, want):
        got, w = ts[n].grad.numpy(), np.asarray(w)
        (assert_elementwise_close if n == "x" else assert_reduced_close)(got, w, f"grad {n}")


def test_without_grad_the_op_is_the_inference_op(monkeypatch):
    """No grad wanted (serving, torch.export): the inference custom op runs,
    not the differentiable save-forward; with grad wanted, the reverse."""
    a = _args(B=2, T=11, seed=1)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    wb = [t(a[n].T) if n in _W else t(a[n]) for pair in zip(_W, _B) for n in pair]
    args = [t(a["x"]), t(a["lns"]), t(a["lnb"]), *wb, a["H"], t(a["ls"]), t(a["dp"])]
    calls = []
    save_forward = port.FusedAttentionFunction.apply
    monkeypatch.setattr(port.FusedAttentionFunction, "apply",
                        lambda *s: calls.append("save") or save_forward(*s))
    inference_op = port._fused_attn_op
    monkeypatch.setattr(port, "_fused_attn_op", lambda *s: calls.append("op") or inference_op(*s))
    args[3].requires_grad_()
    with torch.no_grad():
        served = port.fused_attention_block(*args)
    assert calls == ["op"] and served.grad_fn is None
    trained = port.fused_attention_block(*args)
    assert calls == ["op", "save"] and trained.grad_fn is not None
    assert torch.equal(served, trained.detach())
