"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``gpu``: these need an NVIDIA Hopper card and ``nvcc`` and skip
elsewhere (the CPU suite holds the plain versions against the JAX kernels).
The test imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances are chip_smoke.py's: kernel and plain version round at the same
points and differ in f32 summation order (wmma tiles vs cuBLAS), so max abs
error ≤ 1e-3·max|plain| for f32 inputs and ≤ 2e-2·max|plain| for bf16.
"""

import pytest
import torch

from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import block_attention as ba
from vision_toolbox_tpu_torch.ops import block_mlp as bm

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
