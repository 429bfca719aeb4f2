"""Port K3 backward (vision_toolbox_tpu_torch/ops/block_mlp.py) vs the JAX
kernels.

The port's plain save-forward and plain backward get the same numpy inputs
and output cotangent as JAX ``_fused_mlp_fwd`` / ``_fused_mlp_bwd`` in
interpret mode (weights bf16, as ``fused_mlp_block`` hands them to the
kernel). Every save and every gradient is compared:

- elementwise tensors (out, the saves, dx) with tests/torch_parity.py's
  ``assert_matches_kernel`` (both sides round at the same points; f32 sums
  in another order flip a bf16 rounding now and then), each normalised by
  max(1, max|JAX|);
- reduced and weight gradients to |port − JAX| ≤ 2e-2·max(1, max|JAX|), the
  bound tests/test_block_kernels.py holds the JAX kernels' gradients to.

Then ``torch.autograd`` through the port's public ``fused_mlp_block`` is
held against ``jax.grad`` through the JAX one, and the op without gradients
is shown to run the inference op, not the save-forward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import as_f32, assert_elementwise_close, assert_reduced_close

import vision_toolbox_tpu.ops.block_mlp as bm
from vision_toolbox_tpu_torch.ops import block_mlp as port

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _args(B, T, D=128, Dh=512, seed=0, ls=True, dp=True, res=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    a = {
        "x": f(B, T, D), "lns": 1.0 + 0.1 * f(D), "lnb": 0.1 * f(D),
        "w1": f(D, Dh) * D**-0.5, "b1": 0.1 * f(Dh), "w2": f(Dh, D) * Dh**-0.5, "b2": 0.1 * f(D),
        "ls": 0.5 + 0.2 * f(D) if ls else None,
        "dp": ((rng.random((B, 1)) < 0.7) / 0.7).astype(np.float32) if dp else None,
        "res": f(B, T, D) if res else None,
        "dout": f(B, T, D),
    }
    return a


def _jax_fwd_bwd(a, jdt):
    """JAX ``_fused_mlp_fwd`` then ``_fused_mlp_bwd`` (interpret mode)."""
    j = lambda v, dt=jdt: None if v is None else jnp.asarray(v).astype(dt)
    has_ls, has_res = a["ls"] is not None, a["res"] is not None
    D = a["x"].shape[-1]
    ls = j(a["ls"]) if has_ls else jnp.ones((D,), jnp.float32)
    dp = j(a["dp"], jnp.float32) if a["dp"] is not None else jnp.ones((a["x"].shape[0], 1))
    x = j(a["x"])
    res = j(a["res"]) if has_res else x
    w1, w2 = j(a["w1"], jnp.bfloat16), j(a["w2"], jnp.bfloat16)
    out, saved = bm._fused_mlp_fwd(x, j(a["lns"]), j(a["lnb"]), w1, j(a["b1"]), w2, j(a["b2"]),
                                   ls, dp, res, 1, has_ls, has_res, True, 1e-6)
    grads = bm._fused_mlp_bwd(1, has_ls, has_res, True, 1e-6, saved, j(a["dout"]))
    xhat, rstd, h, g, *_, mlpout = saved
    return out, (xhat, rstd, h, g, mlpout), grads


def _port_fwd_bwd(a, tdt):
    t = lambda v, dt=tdt: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).to(dt)
    ops = [t(a["lns"]), t(a["lnb"]), t(a["w1"].T, torch.bfloat16), t(a["b1"]),
           t(a["w2"].T, torch.bfloat16), t(a["b2"])]
    ls, dp = t(a["ls"]), t(a["dp"], torch.float32)
    out, saves = port.fused_mlp_save_plain(t(a["x"]), *ops, ls, dp, t(a["res"]), 1e-6)
    grads = port.fused_mlp_vjp(t(a["dout"]), saves, *ops, ls, dp, a["res"] is not None)
    return out, saves, grads


CASES = [  # (T, ls, dp, residual, dtype)
    (11, True, True, False, "float32"),
    (17, False, False, False, "float32"),
    (50, True, False, True, "float32"),
    (17, False, True, True, "float32"),
    (11, True, True, False, "bfloat16"),
    (17, False, True, True, "bfloat16"),
    (50, True, False, False, "bfloat16"),
]


@pytest.mark.parametrize("T,ls,dp,res,dtype", CASES)
def test_plain_save_forward_and_backward_match_jax_kernels(T, ls, dp, res, dtype):
    _check_against_jax(_args(B=2, T=T, seed=T, ls=ls, dp=dp, res=res), dtype)


@pytest.mark.parametrize("D,Dh,dtype", [(96, 384, "float32"), (96, 384, "bfloat16"),
                                        (288, 1152, "bfloat16")])
def test_32_column_widths_match_jax_kernels(D, Dh, dtype):
    """The widths K3's 32-column tiles serve, ConvNeXt stage 1 (96, on a 7 × 7
    map) and cait_xs (288), in ConvNeXt's form: γ_ls, drop path and the block
    input as a separate residual."""
    _check_against_jax(_args(B=2, T=49, D=D, Dh=Dh, seed=D, ls=True, dp=True, res=True), dtype)


def _check_against_jax(a, dtype):
    ls, res = a["ls"] is not None, a["res"] is not None
    jdt, tdt = DTYPES[dtype]
    j_out, j_saves, j_grads = _jax_fwd_bwd(a, jdt)
    p_out, p_saves, p_grads = _port_fwd_bwd(a, tdt)

    assert p_out.dtype == tdt and p_grads[0].dtype == tdt
    assert_elementwise_close(as_f32(p_out), as_f32(j_out), "out")
    for name, got, want in zip(("xhat", "rstd", "h", "g", "mlpout"), p_saves, j_saves):
        if want is None:
            assert got is None, name
            continue
        if name == "rstd":
            want = want.reshape(got.shape)
        assert_elementwise_close(as_f32(got), as_f32(want), name)

    dx, dlns, dlnb, dw1, db1, dw2, db2, dls, dres = p_grads
    jdx, jdlns, jdlnb, jdw1, jdb1, jdw2, jdb2, jdls, _, jdres = j_grads
    assert_elementwise_close(as_f32(dx), as_f32(jdx), "dx")
    assert dw1.dtype == dw2.dtype == torch.bfloat16  # the kernel's weight type
    assert_reduced_close(as_f32(dw1), as_f32(jdw1).T, "dW1")
    assert_reduced_close(as_f32(dw2), as_f32(jdw2).T, "dW2")
    for name, got, want in (("dγ_ln", dlns, jdlns), ("dβ_ln", dlnb, jdlnb), ("db1", db1, jdb1),
                            ("db2", db2, jdb2)):
        assert got.dtype == tdt, name  # the bias's / LN parameter's type
        assert_reduced_close(as_f32(got), as_f32(want), name)
    if ls:
        assert_reduced_close(as_f32(dls), as_f32(jdls), "dγ_ls")
    else:
        assert dls is None
    if res:
        np.testing.assert_array_equal(as_f32(dres), as_f32(jdres))  # identity: dout
    else:
        assert dres is None


def test_gelu_grad_as_matches_jax():
    h = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = port.gelu_grad_as(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, np.asarray(bm._gelu_grad_f32(jnp.asarray(h))), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_through_the_op_matches_jax_grad(dtype):
    """``loss = Σ out·w`` through the public ops on both sides: torch.autograd
    on the CPU (the plain save-forward and backward) against jax.grad through
    the Pallas kernels in interpret mode. f32 parameters as a model holds
    them; the ops round the weights to bf16."""
    jdt, tdt = DTYPES[dtype]
    a = _args(B=2, T=17, seed=3, ls=True, dp=True, res=False)
    names = ["x", "lns", "lnb", "w1", "b1", "w2", "b2", "ls"]

    def jloss(x, lns, lnb, w1, b1, w2, b2, ls):
        c = lambda v: v.astype(jdt)
        out = bm.fused_mlp_block(c(x), c(lns), c(lnb), w1, c(b1), w2, c(b2), c(ls),
                                 jnp.asarray(a["dp"]), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(a["dout"]))

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(*(jnp.asarray(a[n]) for n in names))
    ts = {n: torch.from_numpy(np.ascontiguousarray(a[n])).requires_grad_() for n in names}
    c = lambda v: v.to(tdt)
    out = port.fused_mlp_block(c(ts["x"]), c(ts["lns"]), c(ts["lnb"]), ts["w1"].t(), c(ts["b1"]),
                               ts["w2"].t(), c(ts["b2"]), c(ts["ls"]), torch.from_numpy(a["dp"]))
    (out.float() * torch.from_numpy(a["dout"])).sum().backward()
    for n, w in zip(names, want):
        got, w = ts[n].grad.numpy(), np.asarray(w)
        (assert_elementwise_close if n == "x" else assert_reduced_close)(got, w, f"grad {n}")


def test_without_grad_the_op_is_the_inference_op(monkeypatch):
    """No grad wanted (serving, torch.export): the inference custom op runs,
    not the differentiable save-forward; with grad wanted, the reverse."""
    a = _args(B=2, T=11, seed=1)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    args = [t(a["x"]), t(a["lns"]), t(a["lnb"]), t(a["w1"].T), t(a["b1"]), t(a["w2"].T),
            t(a["b2"]), t(a["ls"]), t(a["dp"])]
    calls = []
    save_forward = port.FusedMLPFunction.apply
    monkeypatch.setattr(port.FusedMLPFunction, "apply",
                        lambda *s: calls.append("save") or save_forward(*s))
    inference_op = port._fused_mlp_op
    monkeypatch.setattr(port, "_fused_mlp_op", lambda *s: calls.append("op") or inference_op(*s))
    args[3].requires_grad_()
    with torch.no_grad():
        served = port.fused_mlp_block(*args)
    assert calls == ["op"] and served.grad_fn is None
    trained = port.fused_mlp_block(*args)
    assert calls == ["op", "save"] and trained.grad_fn is not None
    assert torch.equal(served, trained.detach())
