"""Port K4 (vision_toolbox_tpu_torch/ops/block_attention.py) vs the JAX kernel.

The port's op runs its plain PyTorch version on CPU tensors; the JAX side is
``fused_attention_block`` in interpret mode, as tests/test_block_kernels.py
runs it. Same numpy inputs; weights go to the port in the (out, in) layout.
Both sides round y/q/k/v/p/o to bf16 at the same points, so only the f32
summation order differs: tolerance as in tests/torch_parity.py (most
elements within 1e-4, all within 1e-2).
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_parity import assert_matches_kernel, csrc_constant, fake_card

import vision_toolbox_tpu.ops.block_attention as ba
from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import block_attention as port

_W = ("wq", "wk", "wv", "wo")
_B = ("bq", "bk", "bv", "bo")


def _args(B=3, T=19, D=128, H=4, seed=0, ls=True, dp=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    a = {"x": f(B, T, D), "H": H}
    for n in _W:
        a[n] = f(D, D) * D**-0.5
    for n in _B:
        a[n] = 0.1 * f(D)
    a["lns"] = 1.0 + 0.1 * f(D)
    a["lnb"] = 0.1 * f(D)
    a["ls"] = 0.5 + 0.2 * f(D) if ls else None
    a["dp"] = ((rng.random((B, 1)) < 0.8) / 0.8).astype(np.float32) if dp else None
    return a


def _jax(a, group=1):
    j = lambda v: None if v is None else jnp.asarray(v)
    wb = [j(a[n]) for pair in zip(_W, _B) for n in pair]
    out = ba.fused_attention_block(
        j(a["x"]), j(a["lns"]), j(a["lnb"]), *wb, a["H"], j(a["ls"]), j(a["dp"]), group=group,
    )
    return np.asarray(out)


def _port(a, fn=port.fused_attention_block):
    t = lambda v: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
    wb = [t(a[w].T) if w in _W else t(a[w]) for pair in zip(_W, _B) for w in pair]
    return fn(t(a["x"]), t(a["lns"]), t(a["lnb"]), *wb, a["H"], t(a["ls"]), t(a["dp"])).numpy()


@pytest.mark.parametrize("ls,dp,group", [(True, True, 1), (False, False, 3), (True, False, 1)])
def test_fused_attention_matches_jax_kernel(ls, dp, group):
    a = _args(ls=ls, dp=dp, seed=group)
    assert_matches_kernel(_port(a), _jax(a, group))


def test_fused_attention_ragged_tokens():
    # T = 50 fills neither a 16-row tensor-core tile nor a 32-row query tile
    a = _args(B=2, T=50, D=128, H=2, seed=5)
    assert_matches_kernel(_port(a), _jax(a))


def test_op_on_cpu_is_the_plain_version():
    a = _args(seed=6)
    np.testing.assert_array_equal(_port(a), _port(a, port.fused_attention_block_plain))


def test_dispatch_rules():
    assert port.use_fused_attention(768, 12, 197, 0.0, True)  # vit_b_16 @224
    assert port.use_fused_attention(1024, 16, 197, 0.0, True)  # vit_l_16: JAX's 2-slice plan
    assert not port.use_fused_attention(1280, 16, 257, 0.0, True)  # vit_h_14: no JAX plan
    assert not port.use_fused_attention(192, 3, 197, 0.0, True)  # vit_ti_16: d_model % 128
    assert port.use_fused_attention(768, 12, 512, 0.0, True)
    assert not port.use_fused_attention(768, 12, 513, 0.0, True)  # keys exceed one block
    assert not port.use_fused_attention(768, 12, 197, 0.1, True)  # dropout
    assert not port.use_fused_attention(768, 12, 197, 0.0, False)  # no bias
    assert not port.use_fused_attention(768, 32, 197, 0.0, True)  # head_dim 24: not 16-wide
    assert not port.use_fused_attention(768, 3, 197, 0.0, True)  # head_dim 256 > 128
    # head_dim 128 at T=512: the core's largest layout (the save forward's,
    # V following K into one buffer) takes 159.25 KB of shared memory
    assert port._core_smem_bytes(512, 128) == 163072 <= port.SMEM_LIMIT
    assert port.use_fused_attention(1024, 8, 512, 0.0, True)  # JAX's 4-slice plan
    assert port._core_smem_bytes(197, 64) == 98304


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("what", ["type", "weights", "heads", "width", "length", "saves"])
def test_cuda_entries_check_their_arguments(what):
    """The CUDA wrappers refuse what the kernels do not take before anything
    reaches the card (meta tensors: no data, no launch): a type other than
    f32/bf16, weights unlike (D, D), a head width that is no multiple of 16
    or above 128, d_model no multiple of 64, T past one block's keys, saves
    unlike the cotangent."""
    D, H, T = {"heads": (128, 16, 17), "width": (96, 2, 17), "length": (128, 2, 513)}.get(
        what, (128, 2, 17))
    x = _meta(2, T, D, dtype=torch.float16 if what == "type" else torch.bfloat16)
    ws = [_meta(D, D + 32 if what == "weights" and i == 3 else D) for i in range(4)]
    wb = [t for w in ws for t in (w, _meta(D))]
    Tp = T - 1 if what == "saves" else T
    saves = port.AttnSaves(_meta(2, T, D), _meta(2, T, 1, dtype=torch.float32),
                           *(_meta(2, T, D) for _ in range(4)), _meta(2, H, Tp, Tp), None)
    error = TypeError if what == "type" else ValueError
    before = dict(_cuda.LAUNCHES)
    if what != "saves":
        with pytest.raises(error):
            port.fused_attention_save_cuda(x, _meta(D), _meta(D), *wb, H)
        with pytest.raises(error):
            port.fused_attention_block_cuda(x, _meta(D), _meta(D), *wb, H, None, None, 1e-6)
    with pytest.raises(error):
        port.fused_attention_bwd_cuda(x, saves, *ws, _meta(D), None, None, H)
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("B,T,D,H,ls", [(2, 197, 768, 12, False), (3, 50, 128, 2, True),
                                        (1, 512, 256, 4, True)])
def test_wrappers_hand_the_kernels_their_scratch(monkeypatch, B, T, D, H, ls):
    """What the wrappers allocate for the C entries: the forward's bf16 (B, T,
    D) y scratch, and the backward's f32 scratch of column-sum partial rows,
    one row per block of each kernel that writes them (block_bwd.cuh's
    DOUTS_ROWS and LN_ROWS rows; dbq/dbk/dbv a 3·D-wide row per image and
    PARTIAL_ROWS-row tile of block_attention_bwd.cu), its size passed beside
    it; the column sums themselves are not pre-zeroed."""
    lib = fake_card(monkeypatch)
    g = torch.Generator().manual_seed(D)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float32).to(torch.bfloat16)
    x = r(B, T, D)
    wb = [t for _ in range(4) for t in (r(D, D), r(D))]
    gamma = r(D) if ls else None
    _, saves = port.fused_attention_save_cuda(x, r(D), r(D), *wb, H, gamma)
    args = lib.calls["vtt_block_attention_fwd"]
    y = args[-8]
    assert y.shape == (B, T, D) and y.dtype == torch.bfloat16 and args[-7:-4] == (B, T, D)
    monkeypatch.setattr(torch, "zeros", None)  # the column sums are torch.empty
    port.fused_attention_bwd_cuda(x, saves, *wb[::2], r(D), gamma, None, H)
    args = lib.calls["vtt_block_attention_bwd"]
    partials, count = args[-8], args[-7]
    M = B * T
    cdiv = lambda a, b: -(-a // b)
    tile = csrc_constant("PARTIAL_ROWS", "block_attention_bwd.cu")
    rows = {n: cdiv(M, csrc_constant(n, "block_bwd.cuh")) for n in ("DOUTS_ROWS", "LN_ROWS")}
    want = 2 * rows["DOUTS_ROWS"] * D + B * cdiv(T, tile) * 3 * D + 2 * rows["LN_ROWS"] * D
    assert partials.dtype == torch.float32 and partials.numel() == count == want


def _jax_rule(d_model: int, n_heads: int, t: int) -> bool:
    """The JAX package's ``use_fused_attention`` without its TPU test (and
    without dropout, with a bias): d_model % 128, 2 ≤ T ≤ 512 and a
    head-split plan from ``_head_splits``, which traces nothing."""
    return (d_model % 128 == 0 and d_model % n_heads == 0 and 2 <= t <= ba.MAX_SEQ
            and ba._head_splits(d_model, n_heads, t) > 0)


@pytest.mark.parametrize("t", [2, 16, 197, 480, 481, 497, 512, 513])
@pytest.mark.parametrize("d_model", [384, 512, 768, 1024])
def test_gate_admits_the_set_it_admitted(d_model, t):
    """The gate is the JAX rule without its TPU test: at every head width
    16 … 128 that divides d_model, each T, it admits what the reference sends
    through K4 (head 128 above T = 480 too, which the first design's shape
    term refused), since the kernels' own terms hold there; the port's plan
    copy is the JAX package's."""
    for hd in range(16, 129, 16):
        if d_model % hd:
            continue
        h = d_model // hd
        want = _jax_rule(d_model, h, t)
        assert port._head_splits(d_model, h, t) == ba._head_splits(d_model, h, t), (hd, t)
        for ns in (1, 2, 4):
            if h % ns == 0:
                assert (port._program_vmem_bytes(d_model, h, t, ns)
                        == ba._program_vmem_bytes(d_model, h, t, ns=ns)), (hd, t, ns)
        assert port.use_fused_attention(d_model, h, t, 0.0, True) == want, (hd, t)
        if 1 <= t <= 512:
            assert port._kernel_admits(d_model, h, t), (hd, t)


def test_core_smem_term_follows_the_c_layout():
    """``_core_smem_bytes`` mirrors block_attention.cuh ``core_smem_bytes``,
    the one term both CUDA entries refuse a shape by: its constants are the
    header's, and every head width 16 … 128 at every T ≤ 512 fits the
    block's shared memory, so the gate refuses nothing for it."""
    for name, value in (("WMAX", port._WMAX), ("KEY_WARPS", port._KEY_WARPS),
                        ("KEY_BQ", port._KEY_BQ), ("KEY_STAGES", port._KEY_STAGES)):
        assert csrc_constant(name, "block_attention.cuh") == value, name
    text = (Path(port.__file__).resolve().parent.parent / "csrc" / "block_attention.cuh").read_text()
    kg = dict((int(h), int(k)) for h, k in re.findall(
        r"struct Groups<(\d+)> \{\s*static constexpr int KG = (\d+);", text))
    assert kg == port._KG
    m = re.search(r"constexpr size_t kMaxSmem = (\d+) \* (\d+);", text)
    assert int(m.group(1)) * int(m.group(2)) == port.SMEM_LIMIT
    for src in ("block_attention.cu", "block_attention_bwd.cu"):
        body = (Path(port.__file__).resolve().parent.parent / "csrc" / src).read_text()
        assert "vtt_k4::core_smem_bytes(T, " in body, src
    sizes = {hd: [port._core_smem_bytes(t, hd) for t in range(1, 513)] for hd in range(16, 129, 16)}
    assert max(max(v) for v in sizes.values()) <= port.SMEM_LIMIT
    # head 128: K and V in one buffer from T = 385, which keeps T = 512 at
    # 159.25 KB; the largest term is head 96 at T = 496 (K and V apart)
    assert [port._core_smem_bytes(t, 128) for t in (384, 385, 480, 481, 497, 512)] == [
        226560, 131072, 154368, 158720, 163072, 163072]
    assert max((v, t + 1, hd) for hd, row in sizes.items() for t, v in enumerate(row)) == (
        226816, 496, 96)


@pytest.mark.parametrize("B,T,D", [(1, 2, 128), (2, 197, 768), (3, 50, 256), (4, 512, 1024)])
def test_bwd_partial_floats_follow_the_c_layout(B, T, D):
    """``_bwd_partial_floats`` is block_attention_bwd.cu's ``partial_floats``:
    dbo and dγ_ls a row per DOUTS_ROWS rows, dbq/dbk/dbv a 3·D-wide row per
    image and PARTIAL_ROWS-row tile (the core's warps of 16 rows, query rows
    in the rows pass and key rows in the keys pass), dγ_ln and dβ_ln a row
    per LN_ROWS rows."""
    rows = {n: csrc_constant(n, "block_bwd.cuh") for n in ("DOUTS_ROWS", "LN_ROWS")}
    tile = csrc_constant("PARTIAL_ROWS", "block_attention_bwd.cu")
    assert tile == 16
    cdiv = lambda a, b: -(-a // b)
    M = B * T
    want = (2 * cdiv(M, rows["DOUTS_ROWS"]) * D + B * cdiv(T, tile) * 3 * D
            + 2 * cdiv(M, rows["LN_ROWS"]) * D)
    assert port._bwd_partial_floats(B, T, D) == want


@pytest.mark.parametrize("T", [50, 64])
def test_saved_p_rows_are_padded_to_16_bytes(monkeypatch, T):
    """The save forward hands the kernel a (B, H, T, Tp) p, Tp = T rounded
    up to 8, and keeps its [..., :T] view as the save; the backward reads that
    tensor in place, pads a p made elsewhere (the plain save forward's) with
    zeros, and gives its ds scratch the same rows."""
    lib = fake_card(monkeypatch)
    B, D, H = 2, 128, 2
    tp = -(-T // 8) * 8
    g = torch.Generator().manual_seed(T)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float32).to(torch.bfloat16)
    x = r(B, T, D)
    wb = [t for _ in range(4) for t in (r(D, D), r(D))]
    _, saves = port.fused_attention_save_cuda(x, r(D), r(D), *wb, H)
    p_arg = lib.calls["vtt_block_attention_fwd"][-10]
    assert p_arg.shape == (B, H, T, tp) and p_arg.is_contiguous()
    assert saves.p.shape == (B, H, T, T) and saves.p.stride() == (H * T * tp, T * tp, tp, 1)
    assert saves.p.data_ptr() == p_arg.data_ptr()
    port.fused_attention_bwd_cuda(x, saves, *wb[::2], r(D), None, None, H)
    args = lib.calls["vtt_block_attention_bwd"]
    assert args[7].data_ptr() == p_arg.data_ptr() and args[7].shape == (B, H, T, tp)
    assert args[20].shape == (B, H, T, tp)
    plain = r(B, H, T, T)
    port.fused_attention_bwd_cuda(x, saves._replace(p=plain), *wb[::2], r(D), None, None, H)
    padded = lib.calls["vtt_block_attention_bwd"][7]
    assert padded.shape == (B, H, T, tp) and torch.equal(padded[..., :T], plain)
    assert not padded[..., T:].any()
