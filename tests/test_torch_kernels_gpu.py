"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``gpu``: these need an NVIDIA Hopper card and ``nvcc`` and skip
elsewhere (the CPU suite holds the plain versions against the JAX kernels).
The test imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances are chip_smoke.py's: kernel and plain version round at the same
points and differ in f32 summation order (wmma tiles vs cuBLAS), so max abs
error ≤ 1e-3·max|plain| for f32 tensors and ≤ 2e-2·max|plain| for bf16 ones
(one bf16 ulp is 2⁻⁸…2⁻⁷ of a value, so a rounding flip in a bf16 save or
gradient is allowed its ulp). Reduced and weight gradients of the backward
kernels, whose column sums add block partials with atomics in a varying
order: rel L2 ≤ 1e-2. The backward is compared from one set of saves (the
kernel forward's) and one output cotangent. The three-shear warp (K1) forms
every value with the same f32 operations as its plain version: max abs error
≤ 1e-5 on [0, 1] images (measured 0).
"""

import pytest
import torch

from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import block_attention as ba
from vision_toolbox_tpu_torch.ops import block_mlp as bm
from vision_toolbox_tpu_torch.ops import trivial_augment as ta
from vision_toolbox_tpu_torch.ops import warp

pytestmark = pytest.mark.gpu

BOUND = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
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


def _check(got, want, dtype=None):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BOUND[dtype or want.dtype] * want.float().abs().max().item(), err


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
@pytest.mark.parametrize("B,T,D,Dh,extras", [(2, 50, 128, 512, True), (3, 17, 256, 1024, False)])
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
@pytest.mark.parametrize("B,T,D,H", [(2, 50, 128, 2), (3, 197, 256, 4), (1, 512, 128, 2)])
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
                                                 (2, 197, 768, 3072, True, False)])
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
                                            (2, 17, 64, 4, True)])
def test_attention_backward_kernels_match_plain(cuda, dtype, B, T, D, H, extras):
    """Every shape class the forward gate admits: ragged T, T = 512, head
    width 128 at T = 480 (the widest head that fits the forward at that
    length), head width 16."""
    g = torch.Generator().manual_seed(B * T + H)
    to = lambda t: t.to(cuda, dtype)
    x = to(_rand(g, B, T, D))
    ln = [to(_rand(g, D, scale=0.1, shift=1.0)), to(_rand(g, D, scale=0.1))]
    wb = []
    for _ in range(4):
        wb += [to(_rand(g, D, D, scale=D**-0.5)), to(_rand(g, D, scale=0.1))]
    ls = to(_rand(g, D, scale=0.2, shift=0.5)) if extras else None
    dp = _drop_path(g, B, cuda) if extras else None
    assert ba.use_fused_attention(D, H, T, 0.0, True)
    want_out, want_saves = ba.fused_attention_save_plain(x, *ln, *wb, H, ls, dp)
    out, saves = ba.fused_attention_save_cuda(x, *ln, *wb, H, ls, dp)
    dout = to(_rand(g, B, T, D))
    ws = (wb[0], wb[2], wb[4], wb[6])
    before = _cuda.LAUNCHES["block_attention_bwd"]
    got = ba.fused_attention_bwd_cuda(dout, saves, *ws, ln[0], ls, dp, H)
    want = ba.fused_attention_bwd_plain(dout, saves, *ws, ln[0], ls, dp, H)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["block_attention_bwd"] == before + 1
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


@pytest.mark.parametrize("B,S", [(5, 32), (14, 64), (256, 176)])
def test_warp_kernel_matches_plain(cuda, B, S):
    x, op, mag = warp_batch(torch.Generator().manual_seed(S), B, S, cuda)
    program = warp.shear3_params(op, mag)
    want = warp.shear3_warp_plain(x, program)
    before = _cuda.LAUNCHES["warp_shear3"]
    got = warp.shear3_warp(x, op, mag)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["warp_shear3"] == before + 1
    assert got.shape == x.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-5


def test_warp_kernel_checks_its_operands(cuda):
    x, op, mag = warp_batch(torch.Generator().manual_seed(0), 3, 32, cuda)
    with pytest.raises(TypeError):
        warp.shear3_warp(x.double(), op, mag)
    with pytest.raises(ValueError):
        warp.shear3_warp_cuda(x[:, :, :16].contiguous(), warp.shear3_params(op, mag))
    on_cpu = warp.shear3_warp(x.cpu(), op.cpu(), mag.cpu())  # the plain version
    assert (on_cpu - warp.shear3_warp(x, op, mag).cpu()).abs().max().item() <= 1e-5
