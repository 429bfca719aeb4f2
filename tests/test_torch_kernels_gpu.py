"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``gpu``: these need an NVIDIA Hopper card and ``nvcc`` and skip
elsewhere (the CPU suite holds the plain versions against the JAX kernels).
The test imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances are chip_smoke.py's: kernel and plain version round at the same
points and differ in f32 summation order (tensor-core tiles vs cuBLAS), so max abs
error ≤ 1e-3·max|plain| for f32 tensors and ≤ 2e-2·max|plain| for bf16 ones
(one bf16 ulp is 2⁻⁸…2⁻⁷ of a value, so a rounding flip in a bf16 save or
gradient is allowed its ulp). Reduced and weight gradients of the backward
kernels, whose column sums add block partials in another order than the
plain versions': rel L2 ≤ 1e-2; since the K3/K4 redesign they add them in
a fixed order, so a second backward is bit-equal to the first, and TMA's
16-byte alignment is held at the entries; K4's attention core (register
tiles, p and ds one bf16 plane) is held at T = 2, 197, 512 and head 128 at
T = 480, 481, 497 and 512 and at every head width over lengths across its
geometry, its saved p against the plain version's. The backward is compared from one set
of saves (the kernel forward's) and one output cotangent. The three-shear warp (K1) forms
every value with the same f32 operations as its plain version: bit-equal,
0 differing elements. The talking-head kernels (K5) hold
every intermediate in f32 like their plain versions (their products on
the tensor cores with exact bf16 planes) and are held to the same bounds;
their pre-softmax bias gradient, zero in exact arithmetic, against the
pre-softmax mix's; a second backward bit-equal (fixed-order sums). The flash-attention kernels (K6) compute in f32 from the
inputs like their plain versions (their products on the tensor cores with
exact operands) and are held to the bf16 bound and, in f32, to
1e-4·max|plain|, which a kernel that rounds p or ds to bf16 once fails; the
bias is given and not differentiated (its backward is the plain recompute
on every device). The depthwise-conv kernels (K9) sum the same f32 taps in
the same order as their plain versions (out and dx within the dtype's
bound, and bf16 out and dx bit-equal, on the wide route and on an offset
view); dw, summed over the batch and space in another order, by rel L2,
and without atomics: a second backward bit-equal to the first. The
window-attention kernels (K7) compute in f32 from the inputs (bf16 windows
of up to 64 tokens on the tensor cores with p
and ds as two bf16 planes): out, dq, dk, dv within the dtype's bound, dPE by
rel L2, and a second backward bit-equal to the first (no atomics). The
shifted-window relayout kernels (K8) are permutations: bit for bit. The
short-attention kernels (K2) compute in f32 from the inputs like their plain
versions (K6's register tiles and exact-operand planes): out, dq, dk, dv
within the dtype's bound and by rel L2, a second backward bit-equal to the
first, and in bf16 at most half as far (rel L2) from the plain versions as
the second-plane controls (p, and ds, rounded to bf16 once), which the
dtype's bound alone would not refuse.
"""

import copy

import pytest
import torch

from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import block_attention as ba
from vision_toolbox_tpu_torch.ops import block_mlp as bm
from vision_toolbox_tpu_torch.ops import attention as attn
from vision_toolbox_tpu_torch.ops import cait_attention as ca
from vision_toolbox_tpu_torch.ops import flash_attention as fa
from vision_toolbox_tpu_torch.ops import trivial_augment as ta
from vision_toolbox_tpu_torch.ops import warp

pytestmark = pytest.mark.gpu

BOUND = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# K6 in f32: three bf16 planes of every operand keep f32 accuracy (measured
# 1.07e-5·max|plain| on an H100); p or ds rounded to bf16 once gives 1e-3
FLASH_BOUND = BOUND | {torch.float32: 1e-4}
REL_L2 = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests cover the plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, *shape, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=g) * scale + shift


def _check(got, want, dtype=None, bounds=BOUND):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= bounds[dtype or want.dtype] * want.float().abs().max().item(), err


def _check_rel_l2(got, want, what, ref=None):
    """rel L2 ≤ 1e-2, relative to ``ref`` where ``want`` is zero in exact
    arithmetic: the key-bias gradient Σ_rows dk = Σ ds·q vanishes because
    every row of ds sums to zero, so both versions return bf16 rounding
    noise there; it is held against the value-bias gradient of the same
    attention."""
    got, want = got.float(), want.float()
    err = ((got - want).norm() / (want if ref is None else ref.float()).norm()).item()
    assert err <= REL_L2, (what, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,Dh,extras", [(2, 50, 128, 512, True), (3, 17, 256, 1024, False),
                                             (2, 50, 96, 384, True), (3, 17, 288, 1152, False),
                                             (4, 196, 384, 1536, True), (3, 50, 160, 640, False)])
def test_mlp_kernel_matches_plain(cuda, dtype, B, T, D, Dh, extras):
    g = torch.Generator().manual_seed(T)
    a = [_rand(g, B, T, D), _rand(g, D, scale=0.1, shift=1.0), _rand(g, D, scale=0.1),
         _rand(g, Dh, D, scale=D**-0.5), _rand(g, Dh, scale=0.1),
         _rand(g, D, Dh, scale=Dh**-0.5), _rand(g, D, scale=0.1)]
    ls = _rand(g, D, scale=0.2, shift=0.5) if extras else None
    dp = (torch.rand(B, 1, generator=g) < 0.8).float() / 0.8 if extras else None
    res = _rand(g, B, T, D) if extras else None
    to = lambda t: None if t is None else t.to(cuda, dtype)
    a = [to(t) for t in a]
    dp = None if dp is None else dp.to(cuda)
    want = bm.fused_mlp_block_plain(*a, to(ls), dp, to(res))
    before = _cuda.LAUNCHES["block_mlp"]
    got = bm.fused_mlp_block(*a, to(ls), dp, residual=to(res))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["block_mlp"] == before + 1
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", [(2, 50, 128, 2), (3, 197, 256, 4), (1, 512, 128, 2),
                                     (3, 50, 192, 3), (2, 77, 320, 5)])
def test_attention_kernel_matches_plain(cuda, dtype, B, T, D, H):
    g = torch.Generator().manual_seed(T)
    x = _rand(g, B, T, D)
    ln = [_rand(g, D, scale=0.1, shift=1.0), _rand(g, D, scale=0.1)]
    wb = []
    for _ in range(4):
        wb += [_rand(g, D, D, scale=D**-0.5), _rand(g, D, scale=0.1)]
    ls = _rand(g, D, scale=0.2, shift=0.5)
    to = lambda t: t.to(cuda, dtype)
    args = [to(x), *map(to, ln), *map(to, wb)]
    want = ba.fused_attention_block_plain(*args, H, to(ls))
    got = ba.fused_attention_block(*args, H, to(ls))
    torch.cuda.synchronize()
    _check(got, want, dtype)


def _mlp_operands(g, B, T, D, Dh, dtype, extras, cuda):
    to = lambda t: t.to(cuda, dtype)
    ops = [to(_rand(g, D, scale=0.1, shift=1.0)), to(_rand(g, D, scale=0.1)),
           to(_rand(g, Dh, D, scale=D**-0.5)), to(_rand(g, Dh, scale=0.1)),
           to(_rand(g, D, Dh, scale=Dh**-0.5)), to(_rand(g, D, scale=0.1))]
    ls = to(_rand(g, D, scale=0.2, shift=0.5)) if extras else None
    return to(_rand(g, B, T, D)), ops, ls, _drop_path(g, B, cuda) if extras else None


def _drop_path(g, B, device):
    """Per-image drop-path scales with image 0 kept (a batch of one that
    drew a drop would have no gradient to compare)."""
    keep = torch.rand(B, 1, generator=g) < 0.7
    keep[0] = True
    return (keep.float() / 0.7).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,Dh,extras,res", [(2, 50, 128, 512, True, True),
                                                 (3, 17, 256, 1024, False, False),
                                                 (2, 197, 768, 3072, True, False),
                                                 (2, 196, 96, 384, True, True),
                                                 (3, 17, 288, 1152, False, False),
                                                 (4, 196, 384, 1536, True, False),
                                                 (3, 50, 160, 640, False, True)])
def test_mlp_backward_kernels_match_plain(cuda, dtype, B, T, D, Dh, extras, res):
    g = torch.Generator().manual_seed(B * T)
    x, ops, ls, dp = _mlp_operands(g, B, T, D, Dh, dtype, extras, cuda)
    residual = _rand(g, B, T, D).to(cuda, dtype) if res else None
    want_out, want_saves = bm.fused_mlp_save_plain(x, *ops, ls, dp, residual)
    out, saves = bm.fused_mlp_save_cuda(x, *ops, ls, dp, residual)
    dout = _rand(g, B, T, D).to(cuda, dtype)
    before = _cuda.LAUNCHES["block_mlp_bwd"]
    got = bm.fused_mlp_bwd_cuda(dout, saves, ops[2], ops[4], ops[0], ls, dp, res)
    want = bm.fused_mlp_bwd_plain(dout, saves, ops[2], ops[4], ops[0], ls, dp, res)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["block_mlp_bwd"] == before + 1
    _check(out, want_out)
    for name, a, b in zip(bm.MLPSaves._fields, saves, want_saves):
        assert (a is None) == (b is None), name
        if a is not None:
            _check(a, b)
    _check(got.dx, want.dx)
    _check(got.dh, want.dh)
    for name in ("db1", "db2", "dln_scale", "dln_bias") + (("dls",) if extras else ()):
        _check_rel_l2(getattr(got, name), getattr(want, name), name)
    y2 = (saves.xhat.float() * ops[0].float() + ops[1].float()).to(torch.bfloat16)
    _check_rel_l2(bm.weight_grad(got.dh, y2, ops[2]), bm.weight_grad(want.dh, y2, ops[2]), "dW1")


@pytest.mark.parametrize("M,N", [(3072, 768), (768, 3072), (768, 768)])
def test_weight_grad_rounds_once_from_f32(cuda, M, N):
    """The block weight gradients at vit_b_16 batch 128 (rows B·T = 25216):
    the bf16 product is the f32-operand product rounded to bf16 once. A
    split-K reduction in bf16 would flip a large share of the roundings; f32
    sums in another order flip a few, by one ulp."""
    g = torch.Generator().manual_seed(M + N)
    a = _rand(g, 128 * 197, M).to(cuda, torch.bfloat16)
    b = _rand(g, 128 * 197, N).to(cuda, torch.bfloat16)
    like = torch.empty(0, device=cuda)
    got = bm.weight_grad(a, b, like)
    want = (a.float().t() @ b.float()).to(torch.bfloat16).float()
    assert got.shape == (M, N) and got.dtype == torch.float32
    diff = (got - want).abs()
    flipped = (diff > 0).float().mean().item()
    assert flipped <= 1e-2, flipped
    assert diff.max().item() <= 2**-7 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H,extras", [(2, 50, 128, 2, True), (3, 197, 768, 12, False),
                                            (1, 512, 128, 2, True), (1, 480, 256, 2, False),
                                            (1, 481, 256, 2, True), (1, 497, 512, 4, False),
                                            (2, 512, 768, 6, True), (2, 17, 128, 8, True)])
def test_attention_backward_kernels_match_plain(cuda, dtype, B, T, D, H, extras):
    """Every shape class the forward gate admits: ragged T, T = 512, head
    width 128 at T = 480, 481, 497 and 512 (eight warps a row tile, V
    following K into one buffer), head width 16; a second backward
    bit-equal to the first."""
    assert ba.use_fused_attention(D, H, T, 0.0, True)
    _attention_backward_matches_plain(cuda, dtype, B, T, D, H, extras)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H,extras", [(3, 50, 192, 3, True), (2, 77, 320, 5, False)])
def test_attention_backward_kernels_at_the_narrower_tiles(cuda, dtype, B, T, D, H, extras):
    """Widths the kernels take (d_model % 64) outside the JAX gate's
    d_model % 128: the GEMM template's 96- and 32-column tiles in the
    three-product q/k/v launch and the backward's (K, N) weight reads."""
    assert ba._kernel_admits(D, H, T) and not ba.use_fused_attention(D, H, T, 0.0, True)
    _attention_backward_matches_plain(cuda, dtype, B, T, D, H, extras)


def _attention_backward_matches_plain(cuda, dtype, B, T, D, H, extras):
    g = torch.Generator().manual_seed(B * T + H)
    to = lambda t: t.to(cuda, dtype)
    x = to(_rand(g, B, T, D))
    ln = [to(_rand(g, D, scale=0.1, shift=1.0)), to(_rand(g, D, scale=0.1))]
    wb = []
    for _ in range(4):
        wb += [to(_rand(g, D, D, scale=D**-0.5)), to(_rand(g, D, scale=0.1))]
    ls = to(_rand(g, D, scale=0.2, shift=0.5)) if extras else None
    dp = _drop_path(g, B, cuda) if extras else None
    want_out, want_saves = ba.fused_attention_save_plain(x, *ln, *wb, H, ls, dp)
    out, saves = ba.fused_attention_save_cuda(x, *ln, *wb, H, ls, dp)
    dout = to(_rand(g, B, T, D))
    ws = (wb[0], wb[2], wb[4], wb[6])
    before = _cuda.LAUNCHES["block_attention_bwd"]
    got = ba.fused_attention_bwd_cuda(dout, saves, *ws, ln[0], ls, dp, H)
    want = ba.fused_attention_bwd_plain(dout, saves, *ws, ln[0], ls, dp, H)
    again = ba.fused_attention_bwd_cuda(dout, saves, *ws, ln[0], ls, dp, H)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["block_attention_bwd"] == before + 2
    for name, a, b in zip(got._fields, got, again):
        if a is not None:
            assert torch.equal(a, b), name
    _check(out, want_out)
    for name, a, b in zip(ba.AttnSaves._fields, saves, want_saves):
        assert (a is None) == (b is None), name
        if a is not None:
            _check(a, b)
    for name in ("dx", "dq", "dk", "dv"):
        _check(getattr(got, name).contiguous(), getattr(want, name))
    for name in ("dbq", "dbv", "dbo", "dln_scale", "dln_bias") + (("dls",) if extras else ()):
        _check_rel_l2(getattr(got, name), getattr(want, name), name)
    _check_rel_l2(got.dbk, want.dbk, "dbk", ref=want.dbv)


@pytest.mark.parametrize("kind,B,T,D,extras", [("mlp", 2, 197, 768, False),
                                               ("mlp", 2, 196, 96, True),
                                               ("attention", 3, 197, 768, True)])
def test_block_backward_is_bit_equal_when_run_again(cuda, kind, B, T, D, extras):
    """K3's and K4's column sums leave partial rows for a fixed-order sum (no
    atomics): a second backward on the same operands repeats the first bit
    for bit, dx, dh or dq/dk/dv and every column sum."""
    g = torch.Generator().manual_seed(B * T)
    to = lambda t: t.to(cuda, torch.bfloat16)
    if kind == "mlp":
        x, ops, ls, dp = _mlp_operands(g, B, T, D, 4 * D, torch.bfloat16, extras, cuda)
        res = to(_rand(g, B, T, D)) if extras else None
        _, saves = bm.fused_mlp_save_cuda(x, *ops, ls, dp, res)
        run = lambda: bm.fused_mlp_bwd_cuda(to(dout), saves, ops[2], ops[4], ops[0], ls, dp,
                                            extras)
    else:
        x = to(_rand(g, B, T, D))
        ln = [to(_rand(g, D, scale=0.1, shift=1.0)), to(_rand(g, D, scale=0.1))]
        wb = [to(_rand(g, *s, scale=D**-0.5 if len(s) > 1 else 0.1))
              for _ in range(4) for s in ((D, D), (D,))]
        ls, dp = to(_rand(g, D, scale=0.2, shift=0.5)), _drop_path(g, B, cuda)
        _, saves = ba.fused_attention_save_cuda(x, *ln, *wb, 12, ls, dp)
        run = lambda: ba.fused_attention_bwd_cuda(to(dout), saves, *wb[::2], ln[0], ls, dp, 12)
    dout = _rand(g, B, T, D)
    first, second = run(), run()
    torch.cuda.synchronize()
    for name, a, b in zip(first._fields, first, second):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("B,T,D,H", [(4, 2, 128, 2), (3, 197, 768, 12), (1, 512, 128, 2),
                                     (1, 480, 256, 2)])
def test_attention_core_matches_plain_and_repeats(cuda, B, T, D, H):
    """K4's register-tile core at its corners, bf16: T = 2 (one mostly masked
    16-row tile), 197 (two warps share each row tile's keys), 512 (four),
    and head 128 at T = 480 (eight warps a row tile, V following K into one
    buffer): the save forward and the backward against their plain versions,
    the saved p and the plain version's p, and a second backward bit-equal
    to the first."""
    assert ba.use_fused_attention(D, H, T, 0.0, True)
    _attention_backward_matches_plain(cuda, torch.bfloat16, B, T, D, H, True)
    g = torch.Generator().manual_seed(T)
    to = lambda t: t.to(cuda, torch.bfloat16)
    x = to(_rand(g, B, T, D))
    ln = [to(_rand(g, D, scale=0.1, shift=1.0)), to(_rand(g, D, scale=0.1))]
    wb = [to(_rand(g, *s, scale=D**-0.5 if len(s) > 1 else 0.1))
          for _ in range(4) for s in ((D, D), (D,))]
    _, saves = ba.fused_attention_save_cuda(x, *ln, *wb, H)
    _, want = ba.fused_attention_save_plain(x, *ln, *wb, H)
    _check(saves.p, want.p)
    dout = to(_rand(g, B, T, D))
    first = ba.fused_attention_bwd_cuda(dout, saves, *wb[::2], ln[0], None, None, H)
    second = ba.fused_attention_bwd_cuda(dout, saves, *wb[::2], ln[0], None, None, H)
    torch.cuda.synchronize()
    for name, a, b in zip(first._fields, first, second):
        if a is not None:
            assert torch.equal(a, b), name


def test_attention_core_runs_every_admitted_shape(cuda):
    """Every head width 16 … 128 at lengths across the core's geometry
    (one to eight warps a row tile, K and V side by side or in one buffer):
    the kernel gate admits each, head 128 at T = 481, 497 and 512 too, and
    each runs its save forward and backward within the bf16 bound of the
    plain versions (out, p, dx, dq, dk, dv), a second backward bit-equal."""
    g = torch.Generator().manual_seed(5)
    to = lambda t: t.to(cuda, torch.bfloat16)
    heads = {16: 4, 32: 2, 48: 4, 64: 1, 80: 4, 96: 2, 112: 4, 128: 1}
    ran = 0
    for hd, H in heads.items():
        D = hd * H
        for T in (2, 17, 100, 128, 129, 255, 257, 385, 448, 480, 481, 497, 512):
            assert ba._kernel_admits(D, H, T), (hd, T)
            x = to(_rand(g, 1, T, D))
            ln = [to(_rand(g, D, scale=0.1, shift=1.0)), to(_rand(g, D, scale=0.1))]
            wb = [to(_rand(g, *s, scale=D**-0.5 if len(s) > 1 else 0.1))
                  for _ in range(4) for s in ((D, D), (D,))]
            out, saves = ba.fused_attention_save_cuda(x, *ln, *wb, H)
            want_out, want_saves = ba.fused_attention_save_plain(x, *ln, *wb, H)
            dout = to(_rand(g, 1, T, D))
            got = ba.fused_attention_bwd_cuda(dout, saves, *wb[::2], ln[0], None, None, H)
            want = ba.fused_attention_bwd_plain(dout, saves, *wb[::2], ln[0], None, None, H)
            again = ba.fused_attention_bwd_cuda(dout, saves, *wb[::2], ln[0], None, None, H)
            torch.cuda.synchronize()
            _check(out, want_out)
            _check(saves.p, want_saves.p)
            for n in ("dx", "dq", "dk", "dv"):
                _check(getattr(got, n).contiguous(), getattr(want, n))
            for n, a, b in zip(got._fields, got, again):
                if a is not None:
                    assert torch.equal(a, b), (hd, T, n)
            ran += 1
    assert ran == 104, ran


def test_attention_backward_reads_a_contiguous_p(cuda):
    """A p saved elsewhere, (B, H, T, T) contiguous, is padded for the
    kernels and gives the backward the kernel forward's own saves give."""
    g = torch.Generator().manual_seed(11)
    B, T, D, H = 2, 77, 256, 4
    to = lambda t: t.to(cuda, torch.bfloat16)
    x = to(_rand(g, B, T, D))
    ln = [to(_rand(g, D, scale=0.1, shift=1.0)), to(_rand(g, D, scale=0.1))]
    wb = [to(_rand(g, *s, scale=D**-0.5 if len(s) > 1 else 0.1))
          for _ in range(4) for s in ((D, D), (D,))]
    _, saves = ba.fused_attention_save_cuda(x, *ln, *wb, H)
    assert not saves.p.is_contiguous()
    dout = to(_rand(g, B, T, D))
    got = ba.fused_attention_bwd_cuda(dout, saves._replace(p=saves.p.contiguous()), *wb[::2],
                                      ln[0], None, None, H)
    want = ba.fused_attention_bwd_cuda(dout, saves, *wb[::2], ln[0], None, None, H)
    torch.cuda.synchronize()
    for name, a, b in zip(got._fields, got, want):
        if a is not None:
            assert torch.equal(a, b), name


def test_block_entries_refuse_misaligned_operands(cuda):
    """TMA needs 16-byte-aligned bases and row pitches: a view one element
    into its buffer is refused by the wrapper (ValueError) and, handed to
    the C entry directly, by the entry (RuntimeError from its error code);
    neither falls back to another route, and nothing launches."""
    g = torch.Generator().manual_seed(7)
    B, T, D, Dh = 2, 50, 128, 512
    x, ops, _, _ = _mlp_operands(g, B, T, D, Dh, torch.bfloat16, False, cuda)
    buf = torch.empty(B * T * D + 1, dtype=torch.bfloat16, device=cuda)
    xm = buf[1:].view(B, T, D)
    xm.copy_(x)
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="aligned"):
        bm.fused_mlp_block(xm, *ops)
    wb = [t for _ in range(4) for t in (ops[2][:D], ops[1])]
    with pytest.raises(ValueError, match="aligned"):
        ba.fused_attention_block(xm, ops[0], ops[1], *wb, 2)
    out, gbuf, y = torch.empty_like(x), torch.empty(B, T, Dh, dtype=torch.bfloat16, device=cuda), \
        torch.empty_like(x)
    vec = lambda t: (t.data_ptr(), 1)
    err = _cuda.lib().vtt_block_mlp_fwd(
        xm.data_ptr(), xm.data_ptr(), out.data_ptr(), gbuf.data_ptr(), 1, *vec(ops[0]),
        *vec(ops[1]), ops[2].data_ptr(), *vec(ops[3]), ops[4].data_ptr(), *vec(ops[5]),
        None, 0, None, None, None, None, None, y.data_ptr(), B * T, T, D, Dh, 1e-6,
        _cuda.stream())
    with pytest.raises(RuntimeError, match="misaligned"):
        _cuda.check(err, "fused_mlp_block")
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == before


def test_training_step_through_the_ops_launches_the_backward_kernels(cuda):
    """A tiny bf16 ViT trained one step on the card: loss.backward() runs
    each backward kernel once per block, and the gradients match the plain
    path's from the same state."""
    from vision_toolbox_tpu_torch.models.vit import ViT

    torch.manual_seed(0)
    m = ViT(128, 2, 4, 8, 32, dtype=torch.bfloat16, layer_scale_init=0.1, device=cuda)
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    grads = {}
    for plain in (False, True):
        m.zero_grad()
        _cuda.reset_launch_counts()
        m(x, train=True, plain=plain).float().square().mean().backward()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        assert counts["block_mlp_bwd"] == counts["block_attention_bwd"] == (0 if plain else 2)
        grads[plain] = {n: p.grad.clone() for n, p in m.named_parameters()}
    for n, want in grads[True].items():
        ref = grads[True][n.replace("k_proj", "v_proj")] if n.endswith("k_proj.bias") else None
        _check_rel_l2(grads[False][n], want, n, ref)


def warp_batch(g, B, S, device):
    """[0, 1] images and a program mix: identity, ±shear X/Y, ±translate,
    rotations at k90 = −1, 0, +1 and near ±45° and ±135°, then random ops."""
    fixed = [(ta.OP_IDENTITY, 0.0), (ta.OP_SHEAR_X, 0.9), (ta.OP_SHEAR_X, -0.5),
             (ta.OP_SHEAR_Y, 0.7), (ta.OP_SHEAR_Y, -1.0), (ta.OP_TRANSLATE_X, 0.6),
             (ta.OP_TRANSLATE_Y, -0.8), (ta.OP_ROTATE, 1.0), (ta.OP_ROTATE, -1.0),
             (ta.OP_ROTATE, 1 / 3), (ta.OP_ROTATE, -1 / 3 - 1e-3), (ta.OP_ROTATE, 0.2),
             (ta.OP_ROTATE, 0.98), (ta.OP_EQUALIZE, 0.5)]
    op = torch.randint(0, ta.NUM_OPS, (B,), generator=g)
    mag = torch.rand(B, generator=g) * 2 - 1
    n = min(B, len(fixed))
    op[:n] = torch.tensor([o for o, _ in fixed[:n]])
    mag[:n] = torch.tensor([m for _, m in fixed[:n]])
    x = torch.rand(B, S, S, 3, generator=g)
    return x.to(device), op.to(device), mag.to(device)


def warp_batch_of(g, B, S, kind, device):
    """[0, 1] images under one kind of program: every image a pixel op
    (identity warp), or a rotation by ±135° (k90 = ±1, alternating)."""
    if kind == "identity":
        op = torch.full((B,), ta.OP_SOLARIZE)
        mag = torch.rand(B, generator=g) * 2 - 1
    else:
        op = torch.full((B,), ta.OP_ROTATE)
        mag = torch.where(torch.arange(B) % 2 == 0, 1.0, -1.0)
    x = torch.rand(B, S, S, 3, generator=g)
    return x.to(device), op.to(device), mag.to(device)


@pytest.mark.parametrize("B,S,kind", [(5, 32, "mixed"), (14, 64, "mixed"), (256, 176, "mixed"),
                                      (256, 176, "rotation"), (256, 176, "identity"),
                                      (7, 37, "mixed")])
def test_warp_kernel_matches_plain(cuda, B, S, kind):
    """K1 forms every value with the plain version's f32 operations: bit-equal
    on the mixed program, an all-rotation batch (k90 = ±1, the footprint read
    transposed) and an all-identity one (the copy), and at an odd side (37:
    rows of 111 floats, the scalar copies)."""
    g = torch.Generator().manual_seed(S)
    x, op, mag = (warp_batch(g, B, S, cuda) if kind == "mixed"
                  else warp_batch_of(g, B, S, kind, cuda))
    program = warp.shear3_params(op, mag)
    if kind == "rotation":
        assert set(program[0].tolist()) == {-1, 1}
    want = warp.shear3_warp_plain(x, program)
    before = _cuda.LAUNCHES["warp_shear3"]
    got = warp.shear3_warp(x, op, mag)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["warp_shear3"] == before + 1
    assert got.shape == x.shape and got.dtype == torch.float32
    assert int((got != want).sum().item()) == 0


@pytest.mark.parametrize("route", ["one_channel", "four_channels", "beyond_the_draw_set"])
def test_warp_kernel_takes_every_route(cuda, route):
    """K1's other routes, bit-equal to the plain version: a channel count
    other than 3 (the run-time C kernel, 1 and 4), a program outside the
    draw set whose footprints exceed the shared memory sized for it (the
    tile gathers from device memory); rows of a width that is no multiple of
    16 bytes (4-byte copies and stores) are test_warp_kernel_matches_plain's
    37 px case."""
    g = torch.Generator().manual_seed(17)
    x, op, mag = warp_batch(g, 32, 64, cuda)
    program = warp.shear3_params(op, mag)
    if route in ("one_channel", "four_channels"):
        x = torch.rand(32, 64, 64, 1 if route == "one_channel" else 4, generator=g).to(cuda)
    elif route == "beyond_the_draw_set":
        # three shears of ±0.9 with a quarter turn: a tile's footprint spans
        # ≈ 89 × 143 pixels at 176 px, past the 76 × 76 shared memory holds
        x = torch.rand(8, 176, 176, 3, generator=g).to(cuda)
        sign = torch.tensor([1.0, -1.0] * 4, device=cuda)
        k90 = torch.tensor([0, 1, -1, 0] * 2, dtype=torch.int32, device=cuda)
        program = (k90, 0.9 * sign, 3.0 * sign, -0.9 * sign, -2.0 * sign, 0.9 * sign)
        fp = warp.stage_footprint((0, 0.9, 3.0, -0.9, -2.0, 0.9), 64, 64, 176, 176)
        assert fp.floats > warp.STAGE_FLOATS, fp
    want = warp.shear3_warp_plain(x, program)
    got = warp.shear3_warp_cuda(x, program)
    torch.cuda.synchronize()
    assert int((got != want).sum().item()) == 0


def test_warp_kernel_checks_its_operands(cuda):
    x, op, mag = warp_batch(torch.Generator().manual_seed(0), 3, 32, cuda)
    with pytest.raises(TypeError):
        warp.shear3_warp(x.double(), op, mag)
    with pytest.raises(ValueError):
        warp.shear3_warp_cuda(x[:, :, :16].contiguous(), warp.shear3_params(op, mag))
    on_cpu = warp.shear3_warp(x.cpu(), op.cpu(), mag.cpu())  # the plain version
    assert (on_cpu - warp.shear3_warp(x, op, mag).cpu()).abs().max().item() <= 1e-5


# K5 (talking-head attention) at chip_smoke.py's shapes: cait_s_24 at batch
# 8, cait_xxs and cait_m widths, a ragged T, T ≠ S and head width 64; head
# widths 32, 96 and 160 (zero-padded, and above 128 in chunks), and the JAX
# rule's corner (T, S, N) = (64, 512, 16), where a backward block holds two
# query rows
TALKING_HEAD_SHAPES = [(8, 196, 196, 8, 48), (4, 196, 196, 4, 48), (2, 196, 196, 16, 48),
                       (3, 50, 50, 8, 48), (2, 24, 72, 4, 48), (2, 40, 40, 4, 64),
                       (2, 40, 40, 4, 32), (2, 40, 56, 4, 96), (2, 24, 40, 4, 160),
                       (2, 64, 512, 16, 48), (2, 33, 33, 3, 40)]


def _talking_head_args(g, B, T, S, H, hd, dtype, device):
    D = H * hd
    eye = torch.eye(H)
    qkv = [_rand(g, B, n, D).to(device, dtype) for n in (T, S, S)]
    mixes = [_rand(g, H, H, scale=0.3) + eye, _rand(g, H, scale=0.1),
             _rand(g, H, H, scale=0.3) + eye, _rand(g, H, scale=0.1)]
    return (*qkv, *(m.to(device) for m in mixes)), _rand(g, B, T, D).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,hd", TALKING_HEAD_SHAPES)
def test_talking_head_kernels_match_plain(cuda, dtype, B, T, S, H, hd):
    """K5 forward and backward against their plain versions: tensors within
    the dtype's bound, the mix gradients by rel L2 (the pre-softmax bias's,
    zero in exact arithmetic, against the pre-softmax mix's); each wrapper
    launches its kernel once."""
    args, dout = _talking_head_args(torch.Generator().manual_seed(T + H), B, T, S, H, hd, dtype,
                                    cuda)
    before = dict(_cuda.LAUNCHES)
    out = ca.talking_head_attention(*args)  # no grad needed: the custom op → the kernel
    got = ca.talking_head_bwd_cuda(*args, dout)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["talking_head"] == before["talking_head"] + 1
    assert _cuda.LAUNCHES["talking_head_bwd"] == before["talking_head_bwd"] + 1
    _check(out, ca.talking_head_plain(*args))
    want = ca.talking_head_bwd_plain(*args, dout)
    for g, w in zip(got[:3], want[:3]):
        _check(g, w)
    for name in ("ml", "mw", "mwb"):
        _check_rel_l2(getattr(got[3], name), getattr(want[3], name), name)
    _check_rel_l2(got[3].mlb, want[3].mlb, "mlb", ref=want[3].ml)


def test_talking_head_refuses_what_its_gate_refuses(cuda):
    """No fallback: a CUDA shape outside the kernels' rule (T > 512) raises."""
    args, _ = _talking_head_args(torch.Generator().manual_seed(0), 2, 513, 16, 4, 48,
                                 torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="use_talking_head_kernel"):
        ca.talking_head_attention(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,hd", [(2, 196, 196, 16, 48), (2, 64, 512, 16, 48),
                                        (8, 196, 196, 8, 48)])
def test_talking_head_second_backward_is_bit_equal(cuda, dtype, B, T, S, H, hd):
    """Sixteen heads at cait_m's T = 196, the JAX rule's S = 512 corner and
    cait_s_24: both kernels within the dtype's bound of the plain versions,
    and a second backward bit-equal to the first, the mix gradients
    included (partial rows summed in a fixed order, no atomics)."""
    args, dout = _talking_head_args(torch.Generator().manual_seed(S + H), B, T, S, H, hd, dtype,
                                    cuda)
    _check(ca.talking_head_cuda(*args), ca.talking_head_plain(*args))
    first = ca.talking_head_bwd_cuda(*args, dout)
    second = ca.talking_head_bwd_cuda(*args, dout)
    torch.cuda.synchronize()
    want = ca.talking_head_bwd_plain(*args, dout)
    for g, w in zip(first[:3], want[:3]):
        _check(g, w)
    for a, b in zip((*first[:3], *first[3]), (*second[:3], *second[3])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_talking_head_row_tiles_share_one_ring(cuda, dtype):
    """At four heads (cait_xxs) and a batch whose grid fills the card twice,
    a forward block holds several 16-row query tiles and a keys-pass block
    several 16-key tiles, fed by one K/V (or q/dout) ring: the library says
    so, and the kernels match the plain versions there, the ragged last
    tile of T = S = 196 included."""
    B, T, S, H, hd = 64, 196, 196, 4, 48
    assert ca.kernel_geometry(B, T, S, H, hd, dtype, "fwd")["tiles_per_block"] >= 2
    assert ca.kernel_geometry(B, T, S, H, hd, dtype, "bwd_keys")["tiles_per_block"] >= 2
    args, dout = _talking_head_args(torch.Generator().manual_seed(4), B, T, S, H, hd, dtype, cuda)
    _check(ca.talking_head_cuda(*args), ca.talking_head_plain(*args))
    got, want = ca.talking_head_bwd_cuda(*args, dout), ca.talking_head_bwd_plain(*args, dout)
    for g, w in zip(got[:3], want[:3]):
        _check(g, w)
    for name in ("ml", "mw", "mwb"):
        _check_rel_l2(getattr(got[3], name), getattr(want[3], name), name)


def test_talking_head_keeps_scores_off_the_device(cuda):
    """At cait_s_24 b32 the forward allocates its output (and the padded
    mix buffer) and the backward dq, dk, dv, the rows' statistics and the
    partial sums: less than one (B, H, T, S) tensor of one byte an
    element."""
    B, T, H, hd = 32, 196, 8, 48
    args, dout = _talking_head_args(torch.Generator().manual_seed(6), B, T, T, H, hd,
                                    torch.bfloat16, cuda)
    q = args[0]
    scores = B * H * T * T
    for what, run, made in (("forward", lambda: ca.talking_head_cuda(*args), q.nbytes),
                            ("backward", lambda: ca.talking_head_bwd_cuda(*args, dout),
                             3 * q.nbytes)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_stats()["allocated_bytes.all.current"]
        result = run()
        torch.cuda.synchronize()
        extra = torch.cuda.memory_stats()["allocated_bytes.all.peak"] - base
        assert extra - made < scores, (what, extra, made, scores)
        del result


@pytest.mark.parametrize("name", ["cait_xxs_24", "cait_xxs_36", "cait_xs_24", "cait_s_24",
                                  "cait_s_36", "cait_m_36", "cait_m_48"])
def test_cait_builds_on_the_card_and_runs_its_kernels(cuda, name):
    """Every registered CaiT is built on the card by default; a bf16
    forward at 224 px runs K5 and K3 in each self-attention block (cait_xs,
    D = 288, through K3's 32-column tiles)."""
    import vision_toolbox_tpu_torch as vtt

    m = vtt.create_backbone(name, dtype=torch.bfloat16)
    assert next(m.parameters()).is_cuda
    _cuda.reset_launch_counts()
    with torch.inference_mode():
        out = m(torch.rand(2, 224, 224, 3, device=cuda))
    torch.cuda.synchronize()
    depth = len(m.sa_blocks)
    assert out.shape == (2, m.last_out_channels) and torch.isfinite(out.float()).all()
    assert _cuda.LAUNCHES["talking_head"] == depth
    assert _cuda.LAUNCHES["block_mlp"] == depth


# K6 (flash attention) on (B·N, T, H): siglip vit_b_16's T = S = 1024 with
# head 64, a ragged T ≠ S, head widths 128 and 80 (vit_h_14's), a short one,
# and heads above 128 (in two column chunks): 256 at T = 1024, 160 ragged
FLASH_SHAPES = [(4, 1024, 1024, 64), (3, 1000, 1100, 64), (2, 300, 200, 128),
                (2, 257, 257, 80), (3, 17, 33, 16), (2, 1024, 1024, 256), (2, 100, 70, 160)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BN,T,S,H", FLASH_SHAPES)
@pytest.mark.parametrize("biased", [False, True])
def test_flash_attention_kernels_match_plain(cuda, dtype, BN, T, S, H, biased):
    """K6 forward (out and lse) and backward (dq, dk, dv, unbiased) against
    their plain versions; each wrapper launches its kernels once."""
    g = torch.Generator().manual_seed(T + S + H)
    q, k, v = (_rand(g, BN, n, H).to(cuda, dtype) for n in (T, S, S))
    bias = _rand(g, BN, T, S).to(cuda) if biased else None
    dout = _rand(g, BN, T, H).to(cuda, dtype)
    before = dict(_cuda.LAUNCHES)
    out, lse = fa.flash_attention_cuda(q, k, v, bias)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    _check(out, want_out, bounds=FLASH_BOUND)
    _check(lse, want_lse, torch.float32, FLASH_BOUND)
    if biased:
        return
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    for a, b in zip(got, want):
        _check(a, b, bounds=FLASH_BOUND)


def test_flash_attention_on_the_card_never_falls_back(cuda):
    """At T = 1024 ``dot_product_attention`` launches K6 (forward, and
    backward under autograd); a K2 shape launches K2 and not K6; a type the
    kernels do not take raises."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (_rand(g, 2, 1024, 4, 64).to(cuda, torch.bfloat16).requires_grad_()
               for _ in range(3))
    _cuda.reset_launch_counts()
    attn.dot_product_attention(q, k, v).float().sum().backward()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == _cuda.LAUNCHES["flash_attention_bwd"] == 1
    short = _rand(g, 8, 197, 12, 64).to(cuda, torch.bfloat16)
    _cuda.reset_launch_counts()
    attn.dot_product_attention(short, short, short)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["short_attention"] == 1 and _cuda.LAUNCHES["flash_attention"] == 0
    with pytest.raises(TypeError):
        fa.flash_attention(*(t.detach().half() for t in (q, k, v)))


@pytest.mark.parametrize("head", [256])
def test_flash_attention_runs_head_widths_above_128(cuda, head):
    """The gate admits T = 1024 for any head width, as the JAX package's
    does; on a CUDA tensor a head of 256 runs K6 forward and backward (the
    output and the gradients in two 128-wide column chunks) and matches the
    plain versions; a head above 256 raises and launches nothing."""
    g = torch.Generator().manual_seed(head)
    q, k, v = (_rand(g, 1, 1024, 2, head).to(cuda, torch.bfloat16).requires_grad_()
               for _ in range(3))
    dout = _rand(g, 1, 1024, 2, head).to(cuda, torch.bfloat16)
    _cuda.reset_launch_counts()
    out = attn.dot_product_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == _cuda.LAUNCHES["flash_attention_bwd"] == 1
    want_out = attn.dot_product_attention(q, k, v, plain=True)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    _check(out, want_out, bounds=FLASH_BOUND)
    for a, b in zip(got, want):
        _check(a, b, bounds=FLASH_BOUND)
    wide = _rand(g, 1, 1024, 1, 272).to(cuda, torch.bfloat16)
    _cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim=272"):
        attn.dot_product_attention(wide, wide, wide)
    assert _cuda.LAUNCHES["flash_attention"] == 0


def test_siglip_builds_on_the_card_and_runs_its_kernels(cuda):
    """vit_b_16 SigLIP at 512 px, bf16: each of its 12 blocks runs K6 for
    its attention core and K3 for its MLP half; K4 refuses T = 1024."""
    import vision_toolbox_tpu_torch as vtt

    m = vtt.create_backbone("vit_b_16", img_size=512, weights="siglip", dtype=torch.bfloat16)
    assert next(m.parameters()).is_cuda
    _cuda.reset_launch_counts()
    with torch.inference_mode():
        out = m(torch.rand(2, 512, 512, 3, device=cuda))
        plain = m(torch.rand(2, 512, 512, 3, device=cuda), plain=True)
    torch.cuda.synchronize()
    assert out.shape == (2, 768) and torch.isfinite(out.float()).all()
    assert torch.isfinite(plain.float()).all()
    assert _cuda.LAUNCHES["flash_attention"] == _cuda.LAUNCHES["block_mlp"] == 12
    assert _cuda.LAUNCHES["block_attention"] == 0


def test_flash_attention_pads_head_72(cuda):
    """Head 72 (SigLIP So400m/14 at 448 px) at T = 1024: the kernels
    zero-pad the head to 80 in shared memory (the operands reach them as
    they are, with no relayout copy), K6 runs forward and backward, and
    output and gradients match the plain versions on the unpadded head."""
    g = torch.Generator().manual_seed(72)
    q, k, v = (_rand(g, 2, 1024, 4, 72).to(cuda, torch.bfloat16).requires_grad_()
               for _ in range(3))
    dout = _rand(g, 2, 1024, 4, 72).to(cuda, torch.bfloat16)
    _cuda.reset_launch_counts()
    out = attn.dot_product_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == _cuda.LAUNCHES["flash_attention_bwd"] == 1
    want_out = attn.dot_product_attention(q, k, v, plain=True)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    _check(out, want_out, bounds=FLASH_BOUND)
    for a, b in zip(got, want):
        _check(a, b, bounds=FLASH_BOUND)


@pytest.mark.parametrize("head", [64, 72])
def test_flash_attention_packed_entry_equals_the_flat_entry(cuda, head):
    """The kernels on the packed (B, T, N, H) layout, read and written in
    place, give the same bits as on a flat (B·N, T, H) copy of the same
    data (the case N = 1): out, lse, dq, dk and dv. Head 72 is zero-padded
    to 80 in shared memory on both entries."""
    g = torch.Generator().manual_seed(head)
    B, T, N = 2, 1024, 4
    q, k, v, dout = (_rand(g, B, T, N, head).to(cuda, torch.bfloat16) for _ in range(4))
    flat = lambda t: t.transpose(1, 2).reshape(B * N, T, head).contiguous()
    unflat = lambda t: t.reshape(B, N, T, head).transpose(1, 2)
    out, lse = fa.flash_attention_cuda(q, k, v)
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    flat_out, flat_lse = fa.flash_attention_cuda(flat(q), flat(k), flat(v))
    flat_grads = fa.flash_attention_bwd_cuda(flat(q), flat(k), flat(v), flat_out, flat_lse,
                                             flat(dout))
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
    assert torch.equal(out, unflat(flat_out)) and torch.equal(lse, flat_lse)
    for a, b in zip(grads, flat_grads):
        assert a.shape == q.shape and torch.equal(a, unflat(b))


def test_flash_attention_reads_strided_views_in_place(cuda):
    """q, k and v as views of one (B, T, 3, N, H) tensor, the strides of a
    fused q/k/v projection, give the same bits as contiguous copies, forward
    and backward."""
    g = torch.Generator().manual_seed(3)
    qkv = _rand(g, 2, 1024, 3, 4, 64).to(cuda, torch.bfloat16)
    dout = _rand(g, 2, 1024, 4, 64).to(cuda, torch.bfloat16)
    views = qkv.unbind(2)
    copies = [t.contiguous() for t in views]
    assert not views[0].is_contiguous()
    out, lse = fa.flash_attention_cuda(*views)
    want_out, want_lse = fa.flash_attention_cuda(*copies)
    got = fa.flash_attention_bwd_cuda(*views, out, lse, dout)
    want = fa.flash_attention_bwd_cuda(*copies, want_out, want_lse, dout)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype,head", [(torch.bfloat16, 64), (torch.float32, 256)])
def test_flash_attention_second_backward_is_bit_equal(cuda, dtype, head):
    """The backward has no atomics (dK/dV per key tile, dQ per query tile,
    each summed in a fixed order): a second run gives the same bits."""
    g = torch.Generator().manual_seed(head)
    q, k, v, dout = (_rand(g, 1, 1024, 2, head).to(cuda, dtype) for _ in range(4))
    out, lse = fa.flash_attention_cuda(q, k, v)
    first = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    second = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_makes_no_relayout_copy(cuda):
    """At T = 1024 on CUDA tensors ``dot_product_attention`` allocates, beyond
    its inputs, its output alone when served (no (B·N, T, H) relayout or pad
    copy of q, k, v), and under autograd the output, lse, dq, dk, dv and
    delta: less than half a (B, T, N, H) tensor over those."""
    g = torch.Generator().manual_seed(5)
    q, k, v, dout = (_rand(g, 4, 1024, 12, 64).to(cuda, torch.bfloat16) for _ in range(4))
    one = q.numel() * q.element_size()  # 6 MiB: one (B, T, N, H) tensor
    _cuda.lib()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        out = attn.dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    served = torch.cuda.max_memory_allocated() - base
    assert out.shape == q.shape and out.is_contiguous()
    assert served < one + one // 2, served / one
    del out
    leaves = [t.requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _cuda.reset_launch_counts()
    out = attn.dot_product_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    trained = torch.cuda.max_memory_allocated() - base
    assert _cuda.LAUNCHES["flash_attention"] == _cuda.LAUNCHES["flash_attention_bwd"] == 1
    assert all(d.shape == q.shape for d in grads)
    assert trained < 4 * one + one // 2, trained / one


def test_cait_s_24_at_384_px_builds_and_runs(cuda):
    """cait_s_24 at 384 px (T = 576 > 512): its self-attention takes the JAX
    module's XLA branch (no K5 launch), its MLP halves K3, forward and
    backward."""
    import vision_toolbox_tpu_torch as vtt

    m = vtt.create_backbone("cait_s_24", img_size=384, dtype=torch.bfloat16)
    _cuda.reset_launch_counts()
    out = m(torch.rand(2, 384, 384, 3, device=cuda), train=True, generator=torch.Generator())
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert out.shape == (2, 384) and torch.isfinite(out.float()).all()
    assert _cuda.LAUNCHES["talking_head"] == 0
    assert _cuda.LAUNCHES["block_mlp"] == _cuda.LAUNCHES["block_mlp_bwd"] == 24
    assert torch.isfinite(m.sa_blocks[0].mha.proj_l_kernel.grad).all()


def test_cait_with_32_wide_heads_runs_the_kernels(cuda):
    """A CaiT with 32-wide heads at T = 196 is inside the JAX module's K5
    rule, so it reaches the op, which runs K5 on the zero-padded heads,
    forward and backward: the output matches the plain versions' and the
    mix gradients are finite (the kernels' own gradients are held
    elementwise in ``test_talking_head_kernels_match_plain``)."""
    from vision_toolbox_tpu_torch.models.cait import CaiT

    m = CaiT(d_model=128, sa_depth=1, ca_depth=1, n_heads=4, patch_size=16, img_size=224,
             dtype=torch.bfloat16)
    x = torch.rand(2, 224, 224, 3, device=cuda)
    _cuda.reset_launch_counts()
    out = m(x)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["talking_head"] == _cuda.LAUNCHES["talking_head_bwd"] == 1
    assert torch.isfinite(m.sa_blocks[0].mha.proj_w_kernel.grad).all()
    with torch.no_grad():
        want = m(x, plain=True)
    err = ((out.float() - want.float()).norm() / want.float().norm()).item()
    assert err <= REL_L2, err


# K9 (depthwise conv) on NHWC (B, H, W, C) with k: convnext_t stage 1, a C
# that is no multiple of 8 over ragged tiles, k = 3 and 5, a run-time k (9),
# convnext_t's 7 × 7 and 14 × 14 stages (several images a block), a one-wide
# map and the gate's top k (21)
DEPTHWISE_SHAPES = [(2, 56, 56, 96, 7), (3, 13, 17, 20, 7), (2, 9, 9, 32, 3), (2, 10, 7, 24, 5),
                    (1, 12, 20, 16, 9), (4, 7, 7, 768, 7), (3, 14, 14, 384, 7),
                    (3, 11, 1, 64, 7), (1, 9, 12, 32, 21)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,k", DEPTHWISE_SHAPES)
def test_depthwise_conv_kernels_match_plain(cuda, dtype, B, H, W, C, k):
    """K9 forward and backward against their plain versions: out and dx
    within the dtype's bound, dw by rel L2 (another f32 summation order);
    each wrapper launches its kernels once."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    g = torch.Generator().manual_seed(B * H * W + C + k)
    x = _rand(g, B, H, W, C).to(cuda, dtype)
    w = _rand(g, k, k, 1, C, scale=0.2).to(cuda, dtype)
    dout = _rand(g, B, H, W, C).to(cuda, dtype)
    before = dict(_cuda.LAUNCHES)
    out = dc.depthwise_conv2d(x, w)
    dx, dw = dc.depthwise_conv2d_bwd_cuda(x, w, dout)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["depthwise_conv"] == before["depthwise_conv"] + 1
    assert _cuda.LAUNCHES["depthwise_conv_bwd"] == before["depthwise_conv_bwd"] + 1
    _check(out, dc.depthwise_conv2d_plain(x, w))
    want_dx, want_dw = dc.depthwise_conv2d_bwd_plain(x, w, dout)
    _check(dx, want_dx)
    assert dw.dtype == want_dw.dtype
    _check_rel_l2(dw, want_dw, "dw")


def _depthwise_args(g, B, H, W, C, k, dtype, cuda, offset=0):
    """x, w and a cotangent like x; x and the cotangent ``offset`` elements
    into their buffers (an offset view is contiguous but not 16-byte
    aligned)."""
    def view(*shape, scale=1.0, offset=0):
        buf = torch.empty(torch.Size(shape).numel() + offset, dtype=dtype, device=cuda)
        t = buf[offset:].view(shape)
        t.copy_(_rand(g, *shape, scale=scale))
        return t
    return view(B, H, W, C, offset=offset), view(k, k, 1, C, scale=0.2), \
        view(B, H, W, C, offset=offset)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("B,H,W,C,k", DEPTHWISE_SHAPES)
def test_depthwise_conv_bf16_is_bit_equal_to_plain(cuda, B, H, W, C, k, offset):
    """In bf16 the kernels sum the plain versions' f32 taps in their order and
    round once: out and dx equal the plain versions bit for bit, on the wide
    route and on an offset view (the scalar route)."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    g = torch.Generator().manual_seed(B * H * W + C + k + offset)
    x, w, dout = _depthwise_args(g, B, H, W, C, k, torch.bfloat16, cuda, offset)
    out = dc.depthwise_conv2d_cuda(x, w)
    dx, _ = dc.depthwise_conv2d_bwd_cuda(x, w, dout)
    torch.cuda.synchronize()
    assert torch.equal(out, dc.depthwise_conv2d_plain(x, w))
    assert torch.equal(dx, dc.depthwise_conv2d_bwd_plain(x, w, dout)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,k", [(8, 56, 56, 96, 7), (3, 13, 17, 20, 7), (1, 12, 20, 16, 9)])
def test_depthwise_conv_second_backward_is_bit_equal(cuda, dtype, B, H, W, C, k):
    """dw is summed without atomics in a fixed order: a second backward
    equals the first bit for bit."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    g = torch.Generator().manual_seed(7)
    x, w, dout = _depthwise_args(g, B, H, W, C, k, dtype, cuda)
    first = dc.depthwise_conv2d_bwd_cuda(x, w, dout)
    second = dc.depthwise_conv2d_bwd_cuda(x, w, dout)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_depthwise_conv_route_follows_alignment(cuda):
    """The library stages 16-byte copies where C and the pointers allow (the
    wide route) and one element at a time otherwise: an offset view, a C
    that is no multiple of 8 bf16 (4 f32) values; both routes give the
    same result on the same values."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    g = torch.Generator().manual_seed(3)
    x, w, dout = _depthwise_args(g, 2, 14, 14, 64, 7, torch.bfloat16, cuda)
    xo, _, go = _depthwise_args(torch.Generator().manual_seed(3), 2, 14, 14, 64, 7,
                                torch.bfloat16, cuda, offset=1)
    assert dc.kernel_route(x) == dc.kernel_route(x, dout) == "wide"
    assert dc.kernel_route(xo) == dc.kernel_route(x, go) == dc.kernel_route(xo, go) == "scalar"
    assert dc.kernel_route(torch.zeros(1, 4, 4, 20, dtype=torch.bfloat16, device=cuda)) == "scalar"
    assert dc.kernel_route(torch.zeros(1, 4, 4, 20, device=cuda)) == "wide"
    assert dc.kernel_route(torch.zeros(1, 4, 4, 6, device=cuda)) == "scalar"
    assert torch.equal(xo, x) and torch.equal(go, dout)
    assert torch.equal(dc.depthwise_conv2d_cuda(xo, w), dc.depthwise_conv2d_cuda(x, w))
    wide, scalar = dc.depthwise_conv2d_bwd_cuda(x, w, dout), dc.depthwise_conv2d_bwd_cuda(xo, w, go)
    assert all(torch.equal(a, b) for a, b in zip(wide, scalar))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_conv_blocks_walking_several_regions_match_plain(cuda, dtype):
    """At convnext_t stage 1 and batch 32 a persistent block walks several
    regions (bf16 forward blocks through two ring stages, the next region's
    halo loading while this one computes) and a weight-gradient block
    carries its dw sums across them, as the library's geometry shows: bf16
    out and dx bit-equal to the plain versions, f32 within the bound, dw by
    rel L2, and a second backward bit-equal to the first."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    g = torch.Generator().manual_seed(32)
    x, w, dout = _depthwise_args(g, 32, 56, 56, 96, 7, dtype, cuda)
    fwd, wgrad = dc.kernel_geometry(x, w), dc.kernel_geometry(x, w, bwd=True)
    assert fwd["regions_per_block"] > 1 and wgrad["regions_per_block"] > 1, (fwd, wgrad)
    if dtype == torch.bfloat16:
        assert fwd["stages"] == 2, fwd
    out = dc.depthwise_conv2d_cuda(x, w)
    dx, dw = dc.depthwise_conv2d_bwd_cuda(x, w, dout)
    dx2, dw2 = dc.depthwise_conv2d_bwd_cuda(x, w, dout)
    torch.cuda.synchronize()
    want = dc.depthwise_conv2d_plain(x, w)
    want_dx, want_dw = dc.depthwise_conv2d_bwd_plain(x, w, dout)
    if dtype == torch.bfloat16:
        assert torch.equal(out, want) and torch.equal(dx, want_dx)
    else:
        _check(out, want)
        _check(dx, want_dx)
    _check_rel_l2(dw, want_dw, "dw")
    assert torch.equal(dx2, dx) and torch.equal(dw2, dw)


def test_depthwise_conv_on_the_card_never_falls_back(cuda):
    """``DepthwiseConv``, ``ConvNormAct``'s depthwise branch and
    ``SeparableConv2d`` launch K9 on CUDA tensors (its backward under
    autograd); a kernel size or type the kernels lack raises."""
    from vision_toolbox_tpu_torch.nn import layers
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    gen = torch.Generator().manual_seed(0)
    mods = [layers.DepthwiseConv(24, 7, generator=gen),
            layers.ConvNormAct(24, 24, 3, groups=24, generator=gen),
            layers.SeparableConv2d(24, 32, 5, generator=gen)]
    x = torch.rand(2, 14, 14, 24, device=cuda, requires_grad=True)
    for m in mods:
        m.to(cuda)
        _cuda.reset_launch_counts()
        m(x).float().sum().backward()
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["depthwise_conv"] == _cuda.LAUNCHES["depthwise_conv_bwd"] == 1, m
    with pytest.raises(ValueError, match="use_depthwise_kernel"):
        dc.depthwise_conv2d(x.detach(), torch.rand(23, 23, 1, 24, device=cuda))
    with pytest.raises(TypeError):
        dc.depthwise_conv2d(x.detach().half(), torch.rand(7, 7, 1, 24, device=cuda).half())


def test_convnext_builds_on_the_card_and_runs_its_kernels(cuda):
    """convnext_t, bf16: each of its 18 blocks runs K9 and K3 forward (a
    served forward), then forward and backward in training; convnextv2_t
    runs K9 and no K3 (GRN sits inside its MLP)."""
    import vision_toolbox_tpu_torch as vtt

    m = vtt.create_backbone("convnext_t", dtype=torch.bfloat16, stochastic_depth=0.1)
    assert next(m.parameters()).is_cuda
    x = torch.rand(2, 224, 224, 3, device=cuda)
    _cuda.reset_launch_counts()
    with torch.inference_mode():
        out = m(x)
    torch.cuda.synchronize()
    assert out.shape == (2, 768) and torch.isfinite(out.float()).all()
    assert _cuda.LAUNCHES["depthwise_conv"] == _cuda.LAUNCHES["block_mlp"] == 18
    _cuda.reset_launch_counts()
    m(x, train=True, generator=torch.Generator(device=cuda)).float().sum().backward()
    torch.cuda.synchronize()
    for name in ("depthwise_conv", "depthwise_conv_bwd", "block_mlp", "block_mlp_bwd"):
        assert _cuda.LAUNCHES[name] == 18, (name, dict(_cuda.LAUNCHES))
    v2 = vtt.create_backbone("convnextv2_t", dtype=torch.bfloat16)
    _cuda.reset_launch_counts()
    with torch.inference_mode():
        assert torch.isfinite(v2(x).float()).all()
    assert _cuda.LAUNCHES["depthwise_conv"] == 18 and _cuda.LAUNCHES["block_mlp"] == 0


# K7 (Swin window attention) on (B, nW, T, N·hd): swin_t's four stages at 224
# px (window 7, 32-wide heads; stage 4 unshifted; bf16 on the tensor cores),
# windows 8 and 4 with heads of 128 and 16 (the tensor-core kernels' widest and
# narrowest), window 14 (the S3 variants: T = 196, a dPE plane of 150 KB in
# shared memory beside bf16 operands, in device memory beside f32 ones) with
# and without its mask, one image a block and (SWIN_RUN_SHAPES) two and three
# in turn, T = 256 at head 128, whose operands are read from device memory, and
# a head of 20 (no multiple of 16)
SWIN_RUN_SHAPES = [(32, 1, 196, 12, 32, False), (64, 4, 196, 3, 32, True)]
SWIN_ATTENTION_SHAPES = [(2, 64, 49, 3, 32, True), (2, 16, 49, 6, 32, True),
                         (3, 4, 49, 12, 32, True), (2, 1, 49, 24, 32, False),
                         (2, 3, 64, 2, 128, True), (2, 5, 16, 4, 16, False),
                         (2, 1, 196, 12, 32, False), (1, 16, 196, 3, 32, True),
                         *SWIN_RUN_SHAPES, (1, 2, 256, 2, 128, True), (2, 3, 9, 2, 20, True)]


def _swin_args(g, B, nW, T, N, hd, masked, dtype, device):
    D = N * hd
    q, k, v, dout = (_rand(g, B, nW, T, D).to(device, dtype) for _ in range(4))
    pe = _rand(g, 1, N, T, T, scale=0.5).to(device, dtype)
    mask = None
    if masked:  # the −100 shift mask's pattern: some token pairs cut apart
        mask = (torch.rand(nW, T, T, generator=g) < 0.3).float().mul(-100.0).to(device, dtype)
    return q, k, v, pe, mask, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nW,T,N,hd,masked", SWIN_ATTENTION_SHAPES)
def test_swin_attention_kernels_match_plain(cuda, dtype, B, nW, T, N, hd, masked):
    """K7 forward and backward against their plain versions: out, dq, dk,
    dv within the dtype's bound, dPE (an f32 sum over batch and windows in
    another order) by rel L2; each wrapper launches its kernels once, and
    the backward gives the same bits twice."""
    from vision_toolbox_tpu_torch.ops import swin_attention as sa

    g = torch.Generator().manual_seed(B * nW * T + N + hd)
    q, k, v, pe, mask, dout = _swin_args(g, B, nW, T, N, hd, masked, dtype, cuda)
    before = dict(_cuda.LAUNCHES)
    out = sa.swin_window_attention(q, k, v, pe, mask, N)
    got = sa.swin_attention_bwd_cuda(q, k, v, pe, mask, N, dout)
    again = sa.swin_attention_bwd_cuda(q, k, v, pe, mask, N, dout)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["swin_attention"] == before["swin_attention"] + 1
    assert _cuda.LAUNCHES["swin_attention_bwd"] == before["swin_attention_bwd"] + 2
    _check(out, sa.swin_attention_plain(q, k, v, pe, mask, N))
    want = sa.swin_attention_bwd_plain(q, k, v, pe, mask, N, dout)
    for a, b in zip(got[:3], want[:3]):
        _check(a, b)
    assert got[3].dtype == want[3].dtype == torch.float32
    _check_rel_l2(got[3], want[3], "dpe")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,nW,T,N,hd,masked", SWIN_RUN_SHAPES)
def test_swin_attention_window14_blocks_take_several_images(cuda, B, nW, T, N, hd, masked):
    """At SWIN_RUN_SHAPES, bf16, both kernels run the large-window register
    tiles and a block takes window w of more than one image in turn, so the
    matching test above holds their loop over images."""
    from vision_toolbox_tpu_torch.ops import swin_attention as sa

    g = torch.Generator().manual_seed(B + nW)
    q, _, _, pe, mask, _ = _swin_args(g, 1, nW, T, N, hd, masked, torch.bfloat16, cuda)
    for bwd in (False, True):
        route = sa.kernel_route(q, pe, mask, N, bwd)
        assert route == sa.ROUTE_LARGE and sa.windows_per_block(B, nW, N, route) > 1


@pytest.mark.parametrize("B,nW,T,N,hd,masked", [(4, 64, 49, 3, 32, True),
                                                (2, 1, 196, 12, 32, False)])
def test_swin_attention_keeps_the_second_plane(cuda, B, nW, T, N, hd, masked):
    """bf16, swin_t stage 1 and window 14: the forward kernel lies at most
    half as far (rel L2) from ``swin_attention_plain`` as
    ``swin_attention_one_plane``, which rounds p to bf16 once; the backward's
    dq, dk and dv at most half as far from ``swin_attention_bwd_plain`` as
    ``swin_attention_bwd_one_plane``, which rounds p (for dv) and ds (for dq
    and dk) once."""
    from vision_toolbox_tpu_torch.ops import swin_attention as sa

    g = torch.Generator().manual_seed(B * nW * T + N)
    args = _swin_args(g, B, nW, T, N, hd, masked, torch.bfloat16, cuda)
    q, k, v, pe, mask, dout = args
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    got = (sa.swin_attention_cuda(q, k, v, pe, mask, N),
           *sa.swin_attention_bwd_cuda(*args[:5], N, dout)[:3])
    want = (sa.swin_attention_plain(q, k, v, pe, mask, N),
            *sa.swin_attention_bwd_plain(*args[:5], N, dout)[:3])
    control = (sa.swin_attention_one_plane(q, k, v, pe, mask, N),
               *sa.swin_attention_bwd_one_plane(*args[:5], N, dout)[:3])
    torch.cuda.synchronize()
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got, want, control):
        assert rel(a, b) <= 0.5 * rel(c, b), (name, rel(a, b), rel(c, b))


def test_swin_attention_refuses_what_its_gate_refuses(cuda):
    """No fallback: a window above 256 tokens or a head above 128 raises on
    a CUDA tensor and launches nothing."""
    from vision_toolbox_tpu_torch.ops import swin_attention as sa

    g = torch.Generator().manual_seed(0)
    _cuda.reset_launch_counts()
    for T, N, hd in ((289, 2, 32), (49, 1, 160)):
        q, k, v, pe, mask, _ = _swin_args(g, 1, 2, T, N, hd, True, torch.bfloat16, cuda)
        with pytest.raises(ValueError, match="use_swin_kernel"):
            sa.swin_window_attention(q, k, v, pe, mask, N)
    assert _cuda.LAUNCHES == dict.fromkeys(_cuda.LAUNCHES, 0)


# K8 (shifted-window relayout) (B, H, W, C, w, shift): swin_t's three shifted
# stages at 224 px, a map that is not square, channels whose bytes take 4-,
# 2- and 1-byte copies, and an unshifted one
SWIN_RELAYOUT_SHAPES = [(2, 56, 56, 96, 7, 3), (2, 28, 28, 192, 7, 3), (2, 14, 14, 384, 7, 3),
                        (3, 8, 12, 5, 4, 2), (2, 28, 28, 96, 14, 7), (2, 14, 21, 3, 7, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("B,H,W,C,w,s", SWIN_RELAYOUT_SHAPES)
def test_swin_relayout_kernels_are_bit_exact(cuda, dtype, B, H, W, C, w, s):
    """K8 partition and unpartition equal their plain versions bit for bit,
    and undo each other; each launches once."""
    from vision_toolbox_tpu_torch.ops import swin_relayout as sr

    g = torch.Generator().manual_seed(B * H * W + C)
    x = (torch.randint(0, 256, (B, H, W, C), generator=g) if dtype == torch.uint8
         else _rand(g, B, H, W, C)).to(cuda, dtype)
    before = dict(_cuda.LAUNCHES)
    y = sr.shifted_window_partition_cuda(x, w, s)
    back = sr.shifted_window_unpartition_cuda(y, w, s, H, W)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["swin_partition"] == before["swin_partition"] + 1
    assert _cuda.LAUNCHES["swin_unpartition"] == before["swin_unpartition"] + 1
    assert torch.equal(y, sr.shifted_window_partition_plain(x, w, s))
    assert torch.equal(back, x)
    assert torch.equal(sr.shifted_window_unpartition_cuda(y.flip(0), w, s, H, W),
                       sr.shifted_window_unpartition_plain(y.flip(0), w, s, H, W))


def test_swin_t_builds_on_the_card_and_runs_its_kernels(cuda):
    """swin_t, bf16: a served forward launches 12 K7, 5 + 5 K8 (its five
    shifted blocks) and 12 K3 forward kernels and nothing else; a train
    step with stochastic depth launches 12/12 K7, 10 + 10 K8 (each
    direction's backward is the other) and 12/12 K3."""
    import vision_toolbox_tpu_torch as vtt

    m = vtt.create_backbone("swin_t", dtype=torch.bfloat16, stochastic_depth=0.2)
    assert next(m.parameters()).is_cuda
    x = torch.rand(2, 224, 224, 3, device=cuda)
    _cuda.reset_launch_counts()
    with torch.inference_mode():
        out = m(x)
    torch.cuda.synchronize()
    assert out.shape == (2, 768) and torch.isfinite(out.float()).all()
    assert _cuda.LAUNCHES == dict.fromkeys(_cuda.LAUNCHES, 0) | {
        "swin_attention": 12, "swin_partition": 5, "swin_unpartition": 5, "block_mlp": 12}
    _cuda.reset_launch_counts()
    m(x, train=True, generator=torch.Generator(device=cuda)).float().sum().backward()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == dict.fromkeys(_cuda.LAUNCHES, 0) | {
        "swin_attention": 12, "swin_attention_bwd": 12, "swin_partition": 10,
        "swin_unpartition": 10, "block_mlp": 12, "block_mlp_bwd": 12}
    assert torch.isfinite(m.stages[0][1].mha.relative_pe_table.grad).all()


# K2 (short attention) on (B, T, N, H): vit_b_16 at batch 8 and 128, vit_l_16
# (16 heads of 64), vit_h_14 (16 heads of 80, T = 257), the rule's corner
# (T = S = 512, head 128), cross attention (T ≠ S), T = S = 2 at 64 pairs, and
# heads of 40 and 72 (no multiple of 16: zero-padded in shared memory)
SHORT_SHAPES = [(8, 197, 197, 12, 64), (128, 197, 197, 12, 64), (4, 197, 197, 16, 64),
                (4, 257, 257, 16, 80), (1, 512, 512, 64, 128), (8, 50, 197, 8, 64),
                (64, 2, 2, 1, 64), (4, 197, 197, 16, 40), (2, 65, 33, 32, 72)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,N,H", SHORT_SHAPES)
def test_short_attention_kernels_match_plain(cuda, dtype, B, T, S, N, H):
    """K2 forward and backward against their plain versions: out, dq, dk, dv
    within the dtype's bound and by rel L2; each wrapper launches once, and
    the backward gives the same bits twice (no atomics)."""
    from vision_toolbox_tpu_torch.ops import short_attention as sa

    g = torch.Generator().manual_seed(B * T + S + N * H)
    q = _rand(g, B, T, N, H).to(cuda, dtype)
    k, v = (_rand(g, B, S, N, H).to(cuda, dtype) for _ in range(2))
    dout = _rand(g, B, T, N, H).to(cuda, dtype)
    before = dict(_cuda.LAUNCHES)
    out = sa.short_attention_cuda(q, k, v)
    got = sa.short_attention_bwd_cuda(q, k, v, dout)
    again = sa.short_attention_bwd_cuda(q, k, v, dout)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["short_attention"] == before["short_attention"] + 1
    assert _cuda.LAUNCHES["short_attention_bwd"] == before["short_attention_bwd"] + 2
    _check(out, sa.short_attention_plain(q, k, v))
    for name, a, b in zip(("dq", "dk", "dv"), got, sa.short_attention_bwd_plain(q, k, v, dout)):
        _check(a, b)
        _check_rel_l2(a, b, name)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# the second-plane control's cases: vit_b_16 at batch 8 and a head of 40
SHORT_CONTROL_SHAPES = [(8, 197, 197, 12, 64), (4, 197, 197, 16, 40)]


@pytest.mark.parametrize("B,T,S,N,H", SHORT_CONTROL_SHAPES)
def test_short_attention_keeps_the_second_plane(cuda, B, T, S, N, H):
    """bf16: the forward kernel lies at most half as far (rel L2) from
    ``short_attention_plain`` as ``dense_attention``, which rounds p to bf16
    once; the backward's dq, dk and dv at most half as far from
    ``short_attention_bwd_plain`` as ``short_attention_bwd_one_plane``, which
    rounds p (for dv) and ds (for dq and dk) once. A kernel that fed p or ds
    to the tensor cores as one bf16 plane computes the controls' function
    and fails."""
    from vision_toolbox_tpu_torch.ops import short_attention as sa

    g = torch.Generator().manual_seed(B * T + S + N * H)
    q = _rand(g, B, T, N, H).to(cuda, torch.bfloat16)
    k, v = (_rand(g, B, S, N, H).to(cuda, torch.bfloat16) for _ in range(2))
    dout = _rand(g, B, T, N, H).to(cuda, torch.bfloat16)
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    got = (sa.short_attention_cuda(q, k, v), *sa.short_attention_bwd_cuda(q, k, v, dout))
    want = (sa.short_attention_plain(q, k, v), *sa.short_attention_bwd_plain(q, k, v, dout))
    control = (sa.dense_attention(q, k, v), *sa.short_attention_bwd_one_plane(q, k, v, dout))
    torch.cuda.synchronize()
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got, want, control):
        assert rel(a, b) <= 0.5 * rel(c, b), (name, rel(a, b), rel(c, b))


def test_short_attention_allocates_no_score_tensor(cuda):
    """At vit_b_16 b128 (1536 pairs, T = S = 197) the forward allocates
    nothing beyond its output and the backward nothing beyond dq, dk, dv and
    the per-row lse and delta (``torch.cuda.memory_stats``): no (B·N, T, S)
    tensor, not even of one byte an element."""
    from vision_toolbox_tpu_torch.ops import short_attention as sa

    B, T, N, H = 128, 197, 12, 64
    g = torch.Generator().manual_seed(5)
    q, k, v, dout = (_rand(g, B, T, N, H).to(cuda, torch.bfloat16) for _ in range(4))
    scores = B * N * T * T
    for what, run, made in (
        ("forward", lambda: sa.short_attention_cuda(q, k, v), q.nbytes),
        ("backward", lambda: sa.short_attention_bwd_cuda(q, k, v, dout),
         3 * q.nbytes + 2 * B * N * T * 4),
    ):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_stats()["allocated_bytes.all.current"]
        result = run()
        torch.cuda.synchronize()
        extra = torch.cuda.memory_stats()["allocated_bytes.all.peak"] - base
        assert extra - made < scores, (what, extra, made, scores)
        del result


def test_short_attention_refuses_what_its_gate_refuses(cuda):
    """``dot_product_attention`` on CUDA tensors sends T = 513, a head of 136
    and a bias past K2 (the plain math: no launch), and 60 pairs to the
    JAX package's dense path (no launch); the wrapper itself raises at
    T = 513 and head 136 rather than run the plain math in their place."""
    from vision_toolbox_tpu_torch.ops import short_attention as sa

    g = torch.Generator().manual_seed(0)
    _cuda.reset_launch_counts()
    for B, T, N, H, biased in ((1, 513, 64, 64, False), (1, 197, 64, 136, False),
                               (8, 197, 12, 64, True), (5, 197, 12, 64, False)):
        x = _rand(g, B, T, N, H).to(cuda, torch.bfloat16)
        bias = _rand(g, 1, N, T, T).to(cuda, torch.bfloat16) if biased else None
        out = attn.dot_product_attention(x, x, x, bias=bias)
        assert out.shape == x.shape and torch.isfinite(out.float()).all()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == dict.fromkeys(_cuda.LAUNCHES, 0)
    for T, H in ((513, 64), (197, 136)):
        x = _rand(g, 1, T, 64, H).to(cuda, torch.bfloat16)
        with pytest.raises(ValueError, match="no CUDA kernel"):
            sa.short_attention_cuda(x, x, x)
    assert _cuda.LAUNCHES == dict.fromkeys(_cuda.LAUNCHES, 0)


def test_vit_b_16_with_dropout_and_the_unfused_step_run_k2(cuda):
    """vit_b_16 built with dropout 0.1, bf16: in eval a forward at batch 8
    launches 12 K2 forwards and nothing else (both halves of every block on
    the module chain), at batch 1 (12 pairs) nothing; the unfused train
    step (dropout 0, ``force_unfused``) launches 12 K2 forwards and 12
    backwards, and its gradients match the plain path's by chip_smoke.py's
    step rule: rel L2 ≤ max(2e-2, twice the plain bf16 path's own distance
    from an f32 reference of the same weights). The q/k projection
    gradients need the second term: dq = ds·k cancels down to the bf16
    activations' noise (measured 1.26e-2 between the two paths at block 2)."""
    import functools

    import vision_toolbox_tpu_torch as vtt

    m = vtt.create_backbone("vit_b_16", dtype=torch.bfloat16, dropout=0.1).eval()
    x = torch.rand(8, 224, 224, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    none = dict.fromkeys(_cuda.LAUNCHES, 0)
    with torch.inference_mode():
        _cuda.reset_launch_counts()
        out = m(x)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES == none | {"short_attention": 12}
        _cuda.reset_launch_counts()
        m(x[:1])
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES == none
        _check_rel_l2(out, m(x, plain=True), "logits")

    u = vtt.create_backbone("vit_b_16", dtype=torch.bfloat16)
    u.forward = functools.partial(type(u).forward, u, force_unfused=True)
    # a fixed projection of the features (their mean square is the final
    # LayerNorm's, constant, and would leave only rounding noise to compare)
    proj = torch.randn(8, 768, generator=torch.Generator().manual_seed(3)).to(cuda)
    grads = {}
    for plain in (False, True):
        u.zero_grad()
        _cuda.reset_launch_counts()
        (u(x, train=True, plain=plain).float() * proj).sum().backward()
        torch.cuda.synchronize()
        n = 0 if plain else 12
        assert _cuda.LAUNCHES == none | {"short_attention": n, "short_attention_bwd": n}
        grads[plain] = {k: p.grad.clone() for k, p in u.named_parameters()}
    f32 = vtt.create_backbone("vit_b_16")
    f32.load_state_dict(u.state_dict())
    (f32(x, train=True, force_unfused=True, plain=True) * proj).sum().backward()
    grads["f32"] = {k: p.grad for k, p in f32.named_parameters()}
    # the key-bias gradient is zero in exact arithmetic: held against the value bias's
    scale = lambda k, side: side[k.replace("k_proj", "v_proj") if k.endswith("k_proj.bias")
                                 else k].norm()
    for k in grads["f32"]:
        own = ((grads[True][k] - grads["f32"][k]).norm() / scale(k, grads["f32"])).item()
        err = ((grads[False][k] - grads[True][k]).norm() / scale(k, grads[True])).item()
        assert err <= max(2e-2, 2 * own), (k, err, own)


def test_exported_dropout_vit_runs_at_batch_1_and_8(cuda):
    """The exported vit_b_16 with dropout 0.1 (batch free) answers at batch
    1 (12 pairs: no K2) and 8 (12 K2 launches) as eager does."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.utils.export import export_model, load_exported

    m = vtt.create_backbone("vit_b_16", dtype=torch.bfloat16, dropout=0.1).eval()
    served = load_exported(export_model(m, (8, 224, 224, 3)))
    x = torch.rand(8, 224, 224, 3, generator=torch.Generator().manual_seed(2)).to(cuda)
    for b, n in ((1, 0), (8, 12)):
        with torch.inference_mode():
            want = m(x[:b])
            _cuda.reset_launch_counts()
            got = served(x[:b])
            torch.cuda.synchronize()
        assert _cuda.LAUNCHES["short_attention"] == n, b
        _check_rel_l2(got, want, f"batch {b}")


# PatchConvNet's depthwise conv: k = 3 on its trunk's 14 × 14 maps at 224 px,
# patchconvnet_s (384 channels) and _b (768), batch 8
PATCHCONV_DEPTHWISE_SHAPES = [(8, 14, 14, 384, 3), (8, 14, 14, 768, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,k", PATCHCONV_DEPTHWISE_SHAPES)
def test_depthwise_conv_at_patchconvnet_shapes(cuda, dtype, B, H, W, C, k):
    """K9 at k = 3 on PatchConvNet's trunk: out and dx within the dtype's
    bound (bf16 bit-equal), dw by rel L2, a second backward bit-equal."""
    test_depthwise_conv_kernels_match_plain(cuda, dtype, B, H, W, C, k)
    if dtype == torch.bfloat16:
        test_depthwise_conv_bf16_is_bit_equal_to_plain(cuda, B, H, W, C, k, 0)
    test_depthwise_conv_second_backward_is_bit_equal(cuda, dtype, B, H, W, C, k)


# the Mixer's channel halves: mixer_s_8 (T = 784 tokens, 512 / 2048) and
# mixer_l_16 (T = 196, 1024 / 4096), batch 8, no LayerScale, drop-path or
# separate residual
MIXER_MLP_SHAPES = [(8, 784, 512, 2048), (8, 196, 1024, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,Dh", MIXER_MLP_SHAPES)
def test_mlp_kernels_at_mixer_shapes(cuda, dtype, B, T, D, Dh):
    """K3 forward and backward at the Mixer's widths against their plain
    versions; the gate admits both shapes."""
    assert bm.use_fused_mlp(D, Dh, T, 0.0)
    test_mlp_kernel_matches_plain(cuda, dtype, B, T, D, Dh, False)
    test_mlp_backward_kernels_match_plain(cuda, dtype, B, T, D, Dh, False, False)


@pytest.mark.parametrize("name,per_forward", [
    ("mixer_s_8", {"block_mlp": 8}), ("mixer_b_16", {"block_mlp": 12}),
    ("patchconvnet_s", {"depthwise_conv": 60}), ("vovnet57", {}),
    ("efficientnet_b0", {"depthwise_conv": 12}), ("mobilenet_v3_large", {"depthwise_conv": 11}),
    ("resnet50", {}), ("resnext50_32x4d", {}), ("regnet_y_1_6gf", {}),
])
def test_new_families_build_on_the_card_and_run_their_kernels(cuda, name, per_forward):
    """bf16, 224 px: a served forward launches exactly ``per_forward`` (each
    Mixer block's channel half runs K3, each PatchConvNet block K9 at k = 3,
    each stride-1 MBConv of efficientnet_b0 and mobilenet_v3_large K9 at
    k = 3 or 5, VoVNet, the ResNets and RegNets none), and a train-mode
    forward and backward the same again
    forward and as many backward; where a kernel runs, the kernel path
    against the plain path."""
    import vision_toolbox_tpu_torch as vtt

    m = vtt.create_backbone(name, dtype=torch.bfloat16)
    assert next(m.parameters()).is_cuda
    x = torch.rand(2, 224, 224, 3, device=cuda)
    expected = dict.fromkeys(_cuda.LAUNCHES, 0) | per_forward
    _cuda.reset_launch_counts()
    with torch.inference_mode():
        out = m(x)
        torch.cuda.synchronize()
        assert dict(_cuda.LAUNCHES) == expected
        plain = m(x, plain=True) if per_forward else None
    assert torch.isfinite(out.float()).all()
    if per_forward:
        err = ((out.float() - plain.float()).norm() / plain.float().norm()).item()
        assert err <= REL_L2, err
    _cuda.reset_launch_counts()
    m(x, train=True, generator=torch.Generator(device=cuda)).float().sum().backward()
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == expected | {f"{k}_bwd": n for k, n in per_forward.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_pool_ties_on_the_card_match_the_cpu(cuda, dtype):
    """VoVNet's 3 × 3 / 2 max pool on post-ReLU NHWC maps (an all-zero map
    and a map mostly zero): the card's output equals the CPU's bit for bit,
    and its gradient reaches the same taps (the first maximum of a tied
    window, as the CPU's and XLA's) with the same values up to the order in
    which overlapping windows add theirs."""
    from vision_toolbox_tpu_torch.nn.layers import max_pool_torch

    g = torch.Generator().manual_seed(42)
    maps = [torch.zeros(2, 12, 12, 8),
            torch.relu(torch.randn(4, 22, 22, 32, generator=g) - 1.0)]
    for x in maps:
        ct = torch.rand(max_pool_torch(x, 3, 2, 1).shape, generator=g)
        grads = []
        for device in ("cpu", cuda):
            xd = x.to(device, dtype).detach().requires_grad_()
            out = max_pool_torch(xd, 3, 2, 1)
            out.backward(ct.to(device, dtype))
            grads.append((out.detach().cpu(), xd.grad.cpu()))
        (out_cpu, dx_cpu), (out_card, dx_card) = grads
        assert torch.equal(out_card, out_cpu)
        assert torch.equal(dx_card != 0, dx_cpu != 0)
        torch.testing.assert_close(dx_card.float(), dx_cpu.float(), rtol=1e-2, atol=1e-6)


# the MBConv nets' depthwise convs (efficientnet_b0, mobilenet_v3_large at 224
# px): k = 3 and 5, maps from 112² to 7², channel counts that are no multiple
# of K9's 32-channel group (16, 72, 120, 200) and k = 5 on a 7² map at 1152
MBCONV_DEPTHWISE_SHAPES = [(8, 112, 112, 16, 3), (8, 56, 56, 72, 3), (8, 56, 56, 144, 3),
                           (8, 28, 28, 120, 5), (8, 14, 14, 200, 3), (8, 7, 7, 1152, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,k", MBCONV_DEPTHWISE_SHAPES)
def test_depthwise_conv_at_mbconv_shapes(cuda, dtype, B, H, W, C, k):
    """K9 at the MBConv shapes: out and dx within the dtype's bound (bf16
    bit-equal), dw by rel L2, a second backward bit-equal; both dtypes take
    the wide route (C a multiple of 8 bf16, 4 f32 values)."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    test_depthwise_conv_kernels_match_plain(cuda, dtype, B, H, W, C, k)
    if dtype == torch.bfloat16:
        test_depthwise_conv_bf16_is_bit_equal_to_plain(cuda, B, H, W, C, k, 0)
    test_depthwise_conv_second_backward_is_bit_equal(cuda, dtype, B, H, W, C, k)
    x = torch.zeros(B, H, W, C, device=cuda, dtype=dtype)
    assert dc.kernel_route(x, x) == "wide"


def test_bifpn_on_efficientnet_b0_runs_k9(cuda):
    """BiFPN(64, 3 layers) on efficientnet_b0's five taps, bf16, 224 px: 24
    K9 forward launches (8 separable convs a layer), 24 + 24 in a train-mode
    forward and backward, and the kernel path against the plain path."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.models.necks import BiFPN

    backbone = vtt.create_backbone("efficientnet_b0", dtype=torch.bfloat16)
    neck = BiFPN(backbone.out_channels_list, 64, 3, dtype=torch.bfloat16)
    x = torch.rand(2, 224, 224, 3, device=cuda)
    with torch.inference_mode():
        taps = backbone.get_feature_maps(x)
        _cuda.reset_launch_counts()
        outs = neck(taps)
        torch.cuda.synchronize()
        assert dict(_cuda.LAUNCHES) == dict.fromkeys(_cuda.LAUNCHES, 0) | {"depthwise_conv": 24}
        plain = neck(taps, plain=True)
    assert [o.shape[1:] for o in outs] == [t.shape[1:3] + (64,) for t in taps]
    for o, p in zip(outs, plain):
        assert torch.isfinite(o.float()).all()
        err = ((o.float() - p.float()).norm() / p.float().norm()).item()
        assert err <= REL_L2, err
    taps = [t.clone().requires_grad_() for t in taps]
    _cuda.reset_launch_counts()
    sum(o.float().sum() for o in neck(taps, train=True)).backward()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["depthwise_conv"] == _cuda.LAUNCHES["depthwise_conv_bwd"] == 24
    assert all(torch.isfinite(t.grad.float()).all() for t in taps)


@pytest.mark.parametrize("v2,stride", [(True, 1), (True, 2), (False, 1)])
def test_deform_conv2d_on_the_card_matches_the_cpu(cuda, v2, stride):
    """``DeformableConv2d`` (3×3, padding 1, f32) on the card against the
    same module on the CPU: values and the gradients to x and every
    parameter (gathers and their scatter-add backward summed in another
    order)."""
    from vision_toolbox_tpu_torch.nn.layers import DeformableConv2d

    m = DeformableConv2d(32, 64, 3, stride, padding=1, v2=v2,
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.conv_offset.weight.mul_(8)  # offsets of a few pixels, some off the map
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 28, 28, 32, generator=g)
    results = []
    for device in ("cpu", cuda):
        md = copy.deepcopy(m).to(device)
        xd = x.to(device).detach().requires_grad_()
        out = md(xd)
        ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(device)
        out.backward(ct)
        results.append([out.detach().cpu(), xd.grad.cpu()] +
                       [p.grad.cpu() for p in md.parameters()])
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())
