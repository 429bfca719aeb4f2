"""The port's flash attention (vision_toolbox_tpu_torch/ops/flash_attention.py)
vs the JAX package's Pallas kernel K6 in interpret mode.

Ragged shapes with small blocks on the JAX side (T = 40, S = 56, block 32
query rows by 16 keys), so its running softmax crosses several key blocks
and masks a partial one, and its backward pads the query rows. Both sides
compute every intermediate in f32 from the inputs as given: in f32 only the
order of f32 sums differs (rel L2 ≤ 1e-5). With bf16 q/k/v both round the
output once to bf16, held by tests/torch_parity.py's rule, and the bf16
gradients to rel L2 ≤ 1e-2. lse is f32 on both sides (1e-5).
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import assert_matches_kernel

from vision_toolbox_tpu.ops.flash_attention import _flash_fwd
from vision_toolbox_tpu.ops.flash_attention import flash_attention as jax_flash
from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import attention as port_attention
from vision_toolbox_tpu_torch.ops import flash_attention as fa
from vision_toolbox_tpu_torch.ops.short_attention import use_short

B, T, S, N, H = 2, 40, 56, 2, 32
BLOCKS = dict(block_q=32, block_k=16)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_REL_L2 = 1e-5
BF16_GRAD_REL_L2 = 1e-2


def _inputs(seed: int, bias: bool):
    """q (B, T, N, H), k/v (B, S, N, H), a bias broadcasting against
    (B, N, T, S) over the batch, and an output cotangent; f32 numpy."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return r(B, T, N, H), r(B, S, N, H), r(B, S, N, H), r(1, N, T, S) if bias else None, \
        r(B, T, N, H)


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(a, np.float64).ravel() for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _pairs(x: np.ndarray, n: int) -> np.ndarray:
    """(B, n, N, H) → (B·N, n, H), the kernels' layout."""
    return x.transpose(0, 2, 1, 3).reshape(B * N, n, H)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_forward_matches_the_jax_kernel(dtype, bias):
    """out and lse of ``flash_attention_plain`` vs the JAX ``_flash_fwd``
    (the Pallas forward kernel in interpret mode) on (B·N, T, H)."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, b, _ = _inputs(0, bias)
    q, k, v = _pairs(q, T), _pairs(k, S), _pairs(v, S)
    bf = None if b is None else np.broadcast_to(b, (B, N, T, S)).reshape(B * N, T, S)
    j = lambda a: None if a is None else jnp.asarray(a)
    want_out, want_lse = _flash_fwd(j(q).astype(jdt), j(k).astype(jdt), j(v).astype(jdt), j(bf),
                                    BLOCKS["block_q"], BLOCKS["block_k"], interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    out, lse = fa.flash_attention_plain(t(q).to(tdt), t(k).to(tdt), t(v).to(tdt), t(bf))
    assert out.dtype == tdt and out.shape == (B * N, T, H)
    assert lse.dtype == torch.float32 and lse.shape == (B * N, T, 1)
    assert _rel_l2(lse.numpy(), want_lse) <= F32_REL_L2
    want_out = np.asarray(want_out.astype(jnp.float32))
    if dtype == "float32":
        assert _rel_l2(out.numpy(), want_out) <= F32_REL_L2
    else:
        assert_matches_kernel(out.float().numpy(), want_out)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_matches_jax_grad(dtype, bias):
    """``flash_attention`` under autograd (the plain backward on CPU tensors)
    vs ``jax.grad`` through the JAX kernel in interpret mode: without a bias
    its dK/dV and dQ Pallas kernels, with one its XLA recompute, which also
    gives the bias gradient (summed over the batch the bias broadcasts
    along)."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, b, co = _inputs(1, bias)
    argnums = (0, 1, 2, 3) if bias else (0, 1, 2)

    def loss(q, k, v, b=None):
        out = jax_flash(q, k, v, b, interpret=True, **BLOCKS)
        return jnp.sum(jnp.asarray(co) * out.astype(jnp.float32))

    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + ([jnp.asarray(b)] if bias else [])
    want = jax.grad(loss, argnums=argnums)(*jargs)
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    if bias:
        leaves.append(torch.from_numpy(b).requires_grad_())
    out = fa.flash_attention(*leaves[:3], leaves[3] if bias else None)
    assert out.dtype == tdt and out.shape == (B, T, N, H)
    (out.float() * torch.from_numpy(co)).sum().backward()
    for name, w, leaf in zip("qkvb", want, leaves):
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == leaf.shape, name
        w = np.asarray(w.astype(jnp.float32))
        bound = F32_REL_L2 if dtype == "float32" else BF16_GRAD_REL_L2
        assert _rel_l2(leaf.grad.float().numpy(), w) <= bound, name


def test_backward_saves_nothing_of_size_t_by_s():
    """The autograd function keeps q, k, v, the output and lse for the
    backward: no (T, S) tensor."""
    q, k, v, _, _ = _inputs(2, False)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        fa.flash_attention(*leaves)
    assert saved and all(tuple(s[-2:]) not in ((T, S), (S, T)) for s in saved), saved


@pytest.mark.parametrize("t,admitted", [
    (1024, True),   # siglip vit_b_16 at 512 px
    (1152, True),   # 9 × 128
    (2048, True),
    (4096, True),
    (1025, False),  # a cls token: not 128-aligned (the JAX rule)
    (577, False),   # 384 px
    (1, False),     # the MAP probe
    (896, False),   # 128-aligned but below 1024
    (1000, False),
    (1088, False),  # a multiple of 64, not of 128
])
def test_gate(t, admitted):
    """The JAX package's ``use_pallas`` rule without its TPU check; it
    decides by T alone, as the JAX rule does."""
    assert fa.use_flash_attention(t) is admitted


@pytest.mark.parametrize("head", [72, 256])
def test_attention_sends_every_head_width_to_k6(monkeypatch, head):
    """Head widths the CUDA kernels lack (72: SigLIP So400m/14 at 448 px;
    256) still go to the flash op at T = 1024, as in the JAX package: on a
    CPU tensor its plain version, on a CUDA tensor the kernel, which raises
    for them (tests/test_torch_kernels_gpu.py). Attention dropout keeps the
    manual path."""
    calls = []
    spy = lambda *a, **kw: calls.append(a[0].shape) or fa.flash_attention(*a, **kw)
    monkeypatch.setattr(port_attention, "flash_attention", spy)
    g = torch.Generator().manual_seed(head)
    q, k, v = (torch.randn(1, 1024, 2, head, generator=g) for _ in range(3))
    with torch.no_grad():
        got = port_attention.dot_product_attention(q, k, v)
        port_attention.dot_product_attention(q, k, v, dropout_rate=0.1, generator=g)
    assert calls == [(1, 1024, 2, head)]
    want = fa.flash_attention_plain(*(x.transpose(1, 2).reshape(2, 1024, head) for x in (q, k, v)))
    assert torch.equal(got, want[0].reshape(1, 2, 1024, head).transpose(1, 2))


def test_attention_dispatches_k6_shapes_to_the_op(monkeypatch):
    """``dot_product_attention`` sends T = 1024 to the flash op (and the
    result is the op's) and not T = 1025, 577 or 1; K2's rule admits
    vit_b_16's shape and not T = 1024."""
    calls = []
    spy = lambda *a, **kw: calls.append(a[0].shape) or fa.flash_attention(*a, **kw)
    monkeypatch.setattr(port_attention, "flash_attention", spy)
    g = torch.Generator().manual_seed(3)
    for t, s in ((1024, 1024), (1025, 1025), (577, 577), (1, 1024)):
        q, k, v = (torch.randn(1, n, 2, 32, generator=g) for n in (t, s, s))
        with torch.no_grad():
            got = port_attention.dot_product_attention(q, k, v)
            if t == 1024:
                want = torch.ops.vtt.flash_attention(*(x.transpose(1, 2).reshape(2, -1, 32)
                                                       for x in (q, k, v)), None)
                assert torch.equal(got, want.reshape(1, 2, t, 32).transpose(1, 2))
    assert calls == [(1, 1024, 2, 32)]
    assert use_short(197, 197, 64, 96) and not use_short(1024, 1024, 64, 96)


def test_model_without_grad_runs_the_inference_op(monkeypatch):
    """A SigLIP-style ViT at T = 1024 (128 px, patch 4, MAP head): without
    gradients each block's attention runs the custom op
    ``vtt::flash_attention`` (on CPU its plain version, launching nothing);
    under autograd the autograd function instead."""
    calls = []
    op = fa._flash_attention_op
    monkeypatch.setattr(fa, "_flash_attention_op", lambda *a: calls.append(1) or op(*a))
    m = ViT(64, 2, 2, 4, 128, cls_token=False, pool_type="mha", device="cpu")
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(4))
    before = dict(_cuda.LAUNCHES)
    with torch.no_grad():
        out = m(x)
    assert out.shape == (2, 64) and len(calls) == 2
    m(x, train=True).sum().backward()
    assert len(calls) == 2 and _cuda.LAUNCHES == before
    assert m.blocks[0].mha.q_proj.weight.grad is not None


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_op_on_the_packed_layout_matches_the_jax_kernel(dtype):
    """``vtt::flash_attention`` on (B, T, N, H) CPU tensors, the layout the
    CUDA kernels read in place (on CPU the op relays out inside itself), vs
    the JAX ``flash_attention`` on the same (B, T, N, H) arrays in interpret
    mode, with a (B·N, T, S) bias broadcast from (1, N, T, S)."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, b, _ = _inputs(3, True)
    want = jax_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(b),
                     interpret=True, **BLOCKS)
    t = lambda a: torch.from_numpy(a).to(tdt)
    bias = torch.from_numpy(b).expand(B, N, T, S).reshape(B * N, T, S)
    got = torch.ops.vtt.flash_attention(t(q), t(k), t(v), bias, H**-0.5)
    assert got.shape == (B, T, N, H) and got.dtype == tdt and got.is_contiguous()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        assert _rel_l2(got.numpy(), want) <= F32_REL_L2
    else:
        assert_matches_kernel(got.float().numpy(), want)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _refused(case: str):
    """(q, k, v, bias) for one thing the CUDA kernels do not take, on meta
    tensors (no data, no card): the checks run before any launch."""
    q, k, v = (_meta(2, n, 3, 32) for n in (40, 56, 56))
    bias = None
    if case == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed types":
        k = k.float()
    elif case == "head 272":
        q, k, v = (_meta(2, n, 3, 272) for n in (40, 56, 56))
    elif case == "non-contiguous head":
        q = _meta(2, 40, 3, 64)[..., ::2]
    elif case == "k and v differ":
        v = _meta(2, 57, 3, 32)
    elif case == "q and k heads differ":
        k, v = _meta(2, 56, 4, 32), _meta(2, 56, 4, 32)
    elif case == "batch differs":
        k, v = _meta(1, 56, 3, 32), _meta(1, 56, 3, 32)
    elif case == "rank 5":
        q, k, v = (t.unsqueeze(0) for t in (q, k, v))
    elif case == "too many pairs":
        q, k, v = (_meta(65536, n, 1, 16) for n in (4, 4, 4))
    elif case == "bias shape":
        bias = _meta(2, 3, 40, 56, dtype=torch.float32)
    return q, k, v, bias


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("mixed types", TypeError), ("head 272", ValueError),
    ("non-contiguous head", ValueError), ("k and v differ", ValueError),
    ("q and k heads differ", ValueError), ("batch differs", ValueError), ("rank 5", ValueError),
    ("too many pairs", ValueError), ("bias shape", ValueError),
])
def test_cuda_entry_refuses_what_the_kernels_do_not_take(case, error):
    """The packed entry's checks (``flash_attention_cuda`` and the backward)
    raise on a type other than f32/bf16 or mixed types, a head above 256, a
    head dimension without unit stride, mismatched shapes or ranks, more
    than 65535 (batch·head) pairs and a bias that is not (B·N, T, S)."""
    q, k, v, bias = _refused(case)
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(error):
        fa.flash_attention_cuda(q, k, v, bias)
    if bias is None:
        lse = torch.empty(6, q.shape[1] if q.ndim > 1 else 1, 1, device="meta")
        with pytest.raises(error):
            fa.flash_attention_bwd_cuda(q, k, v, q, lse, q)
    assert _cuda.LAUNCHES == before


def test_cuda_entry_takes_strided_views_and_the_flat_layout():
    """What the kernels do take: q, k and v as strided views of one
    (B, T, 3, N, H) projection (a unit stride along the head is all they
    need) and the flat (B·N, T, H) layout as N = 1; the backward refuses an
    lse that is not (B·N, T, 1)."""
    qkv = _meta(2, 40, 3, 4, 24)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and q.stride(-1) == 1
    assert fa._check_cuda_args(q, k, v, None) == (2, 4, 40, 40, 24)
    flat = _meta(8, 40, 24)
    assert fa._check_cuda_args(flat, _meta(8, 56, 24), _meta(8, 56, 24),
                               _meta(8, 40, 56, dtype=torch.float32)) == (8, 1, 40, 56, 24)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q, k, v, q, torch.empty(8, 40, device="meta"), q)
