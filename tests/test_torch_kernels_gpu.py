"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``gpu``: these need an NVIDIA Hopper card and ``nvcc`` and skip
elsewhere (the CPU suite holds the plain versions against the JAX kernels).
The test imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances are chip_smoke.py's: kernel and plain version round at the same
points and differ in f32 summation order (wmma tiles vs cuBLAS), so max abs
error ≤ 1e-3·max|plain| for f32 inputs and ≤ 2e-2·max|plain| for bf16. The
three-shear warp (K1) forms every value with the same f32 operations as its
plain version: max abs error ≤ 1e-5 on [0, 1] images (measured 0).
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests cover the plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, *shape, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=g) * scale + shift


def _check(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BOUND[dtype] * want.float().abs().max().item(), err


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
