"""Port K3 (vision_toolbox_tpu_torch/ops/block_mlp.py) vs the JAX kernel.

The port's op runs its plain PyTorch version on CPU tensors; the JAX side is
``fused_mlp_block`` in interpret mode, as tests/test_block_kernels.py runs
it. Same numpy inputs to both; the weights go to the port in the nn.Linear
(out, in) layout. Both sides round at the same points (bf16 y2/h/g, f32
accumulation), so only the f32 summation order differs: tolerance as in
tests/torch_parity.py (most elements within 1e-4, all within 1e-2).
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_parity import assert_matches_kernel, csrc_constant, fake_card

import vision_toolbox_tpu.ops.block_mlp as bm
from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import block_mlp as port


def _args(B=3, T=17, D=128, Dh=256, seed=0, ls=True, dp=True, res=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    a = {
        "x": f(B, T, D),
        "lns": 1.0 + 0.1 * f(D),
        "lnb": 0.1 * f(D),
        "w1": f(D, Dh) * D**-0.5,
        "b1": 0.1 * f(Dh),
        "w2": f(Dh, D) * Dh**-0.5,
        "b2": 0.1 * f(D),
    }
    a["ls"] = 0.5 + 0.2 * f(D) if ls else None
    a["dp"] = ((rng.random((B, 1)) < 0.8) / 0.8).astype(np.float32) if dp else None
    a["res"] = f(B, T, D) if res else None
    return a


def _jax(a, group=1):
    j = lambda v: None if v is None else jnp.asarray(v)
    out = bm.fused_mlp_block(
        j(a["x"]), j(a["lns"]), j(a["lnb"]), j(a["w1"]), j(a["b1"]), j(a["w2"]), j(a["b2"]),
        j(a["ls"]), j(a["dp"]), residual=j(a["res"]), group=group,
    )
    return np.asarray(out)


def _port(a, fn=port.fused_mlp_block):
    t = lambda v: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
    out = fn(
        t(a["x"]), t(a["lns"]), t(a["lnb"]), t(a["w1"].T), t(a["b1"]), t(a["w2"].T), t(a["b2"]),
        t(a["ls"]), t(a["dp"]), residual=t(a["res"]),
    )
    return out.numpy()


@pytest.mark.parametrize(
    "ls,dp,group,res",
    [
        (True, True, 1, False),
        (False, False, 2, False),
        (True, False, 3, False),
        (True, True, 1, True),
        (False, True, 2, True),
    ],
)
def test_fused_mlp_matches_jax_kernel(ls, dp, group, res):
    a = _args(ls=ls, dp=dp, res=res, seed=group)
    assert_matches_kernel(_port(a), _jax(a, group))


def test_fused_mlp_hidden_wider_than_1536():
    # Dh > 1536: the JAX kernel tiles the hidden dimension (nj > 1); the
    # port's GEMM streams it, the result must not care
    a = _args(B=2, T=9, D=256, Dh=2048, seed=3)
    assert_matches_kernel(_port(a), _jax(a))


def test_op_on_cpu_is_the_plain_version():
    a = _args(seed=4, res=True)
    np.testing.assert_array_equal(_port(a), _port(a, port.fused_mlp_block_plain))


def test_gelu_as_matches_jax():
    h = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = port.gelu_as(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, np.asarray(bm._gelu_f32(jnp.asarray(h))), rtol=0, atol=1e-6)


def test_dispatch_rules():
    assert port.use_fused_mlp(768, 3072, 197, 0.0)  # vit_b_16
    assert port.use_fused_mlp(192, 768, 197, 0.0)  # vit_ti_16
    assert port.use_fused_mlp(1280, 5120, 257, 0.0)  # vit_h_14: JAX's 4-slice plan
    assert not port.use_fused_mlp(768, 3072, 197, 0.1)  # dropout
    assert port.use_fused_mlp(96, 384, 56 * 56, 0.0)  # Swin-T stage 1: 32-column tiles
    assert port.use_fused_mlp(96, 384, 56 * 56, 0.0, has_res=True, has_ls=True)  # ConvNeXt-T
    assert port.use_fused_mlp(288, 1152, 196, 0.0, has_ls=True)  # cait_xs
    assert not port.use_fused_mlp(40, 160, 56 * 56, 0.0)  # convnext_a stage 1: d % 32
    assert not port.use_fused_mlp(100, 400, 197, 0.0)
    # the JAX plan's budgets: convnext_xl's stage 4 (d 2048) has no hidden
    # split; vit_h_14's widths at T = 1024 (448 px without a cls token) fill
    # its f32 row scratches
    assert not port.use_fused_mlp(2048, 8192, 49, 0.0, has_res=True, has_ls=True)
    assert not port.use_fused_mlp(1280, 5120, 1024, 0.0)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("what", ["type", "weights", "width", "hidden", "residual", "saves"])
def test_cuda_entries_check_their_arguments(what):
    """The CUDA wrappers refuse what the kernels do not take before anything
    reaches the card (meta tensors: no data, no launch): a type other than
    f32/bf16, weights unlike (Dh, D) / (D, Dh), widths that are no multiple
    of the 32-column tile, a residual unlike x, saves unlike the cotangent."""
    D, Dh = {"width": (80, 320), "hidden": (64, 200)}.get(what, (64, 256))
    x = _meta(2, 5, D, dtype=torch.float16 if what == "type" else torch.bfloat16)
    w1 = _meta(Dh, D + 32) if what == "weights" else _meta(Dh, D)
    w2 = _meta(D, Dh)
    res = _meta(2, 5, D, dtype=torch.float32) if what == "residual" else None
    ops = (_meta(D), _meta(D), w1, _meta(Dh), w2, _meta(D))
    saves = port.MLPSaves(_meta(2, 5, D), _meta(2, 5, 1, dtype=torch.float32),
                          _meta(2, 4 if what == "saves" else 5, Dh), _meta(2, 5, Dh), None)
    error = TypeError if what == "type" else ValueError
    before = dict(_cuda.LAUNCHES)
    if what != "saves":
        with pytest.raises(error):
            port.fused_mlp_save_cuda(x, *ops, None, None, res)
        with pytest.raises(error):
            port.fused_mlp_block_cuda(x, *ops, None, None, res, 1e-6)
    if what != "residual":
        with pytest.raises(error):
            port.fused_mlp_bwd_cuda(x, saves, w1, w2, ops[0], None, None, False)
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("B,T,D,Dh,ls", [(2, 197, 768, 3072, False), (3, 17, 96, 384, True),
                                         (1, 130, 288, 1152, True)])
def test_wrappers_hand_the_kernels_their_scratch(monkeypatch, B, T, D, Dh, ls):
    """What the wrappers allocate for the C entries: the forward's bf16 (B, T,
    D) y scratch, and the backward's f32 scratch of column-sum partial rows,
    one row per block of each kernel that writes them (block_bwd.cuh's
    DOUTS_ROWS and LN_ROWS rows, gemm.cuh's BM-row GEMM tiles), its size
    passed beside it for the entry to check; the column sums themselves are
    not pre-zeroed (the kernels' fixed-order sum writes them whole)."""
    lib = fake_card(monkeypatch)
    g = torch.Generator().manual_seed(D)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float32).to(torch.bfloat16)
    x = r(B, T, D)
    ops = (r(D), r(D), r(Dh, D), r(Dh), r(D, Dh), r(D))
    gamma = r(D) if ls else None
    _, saves = port.fused_mlp_save_cuda(x, *ops, gamma)
    args = lib.calls["vtt_block_mlp_fwd"]
    y = args[-7]
    assert y.shape == (B, T, D) and y.dtype == torch.bfloat16 and args[-6] == B * T
    monkeypatch.setattr(torch, "zeros", None)  # the column sums are torch.empty
    port.fused_mlp_bwd_cuda(x, saves, ops[2], ops[4], ops[0], gamma, None, False)
    args = lib.calls["vtt_block_mlp_bwd"]
    partials, count = args[-8], args[-7]
    M = B * T
    cdiv = lambda a, b: -(-a // b)
    rows = {n: cdiv(M, csrc_constant(n, src))
            for n, src in (("DOUTS_ROWS", "block_bwd.cuh"), ("LN_ROWS", "block_bwd.cuh"),
                           ("BM", "gemm.cuh"))}
    want = 2 * rows["DOUTS_ROWS"] * D + rows["BM"] * Dh + 2 * rows["LN_ROWS"] * D
    assert partials.dtype == torch.float32 and partials.numel() == count == want
