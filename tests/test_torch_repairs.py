"""Repairs of the port against the JAX package, each pinned on CPU.

- Plain attention rounds like ``jax.nn.dot_product_attention`` (jax 0.9.0
  ``_dot_product_attention_core``): f32 logits and softmax, then p rounded
  to v's type before p·v. Held in bf16 at T = S = 577 (ViT at 384 px) and
  T = 1 / S = 1024 (SigLIP's MAP probe) by tests/torch_parity.py's rule,
  which the f32-probability version fails. The dropout path follows the JAX
  package's manual path in the input type, with one keep mask fed to both.
- CaiT outside the talking-head kernels' shape rule (T = 576 > 512) and
  CaiT training with attention dropout run the JAX module's XLA branch
  (``TalkingHeadAttention._xla_attention``), at its rounding points: a
  narrow CaiT at 96 px, patch 4, forward in f32 and bf16 and gradients,
  with and without dropout (the same keep masks fed to both sides).
  Tolerances as tests/test_torch_cait.py's: f32 outputs by the parity rule
  with the tight share at 1e-3, bf16 outputs rel L2 ≤ 1e-2, f32 gradients
  rel L2 ≤ 1e-3. The module takes that branch only where neither the JAX
  module's K5 rule nor the CUDA kernels' admits the shape: any head width
  inside the JAX rule reaches the op.
- Flash attention zero-pads a head width the CUDA kernels lack (72) to the
  next multiple of 16 in its relayout copy and passes the true width's
  scale: the padded plain versions equal the unpadded ones (1e-6, f32 sums
  over extra zeros), and ``flash_attention`` with the CUDA padding rule gives
  the unpadded result and gradients.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import contextlib

import numpy as np
import pytest
import torch
from torch_parity import assert_matches_kernel

import jax
import jax.numpy as jnp

import vision_toolbox_tpu.ops.block_mlp as jbm
from vision_toolbox_tpu.models.cait import CaiT as JaxCaiT
from vision_toolbox_tpu.ops.attention import dot_product_attention as jax_manual_attention
from vision_toolbox_tpu_torch.models import cait
from vision_toolbox_tpu_torch.models.cait import CaiT
from vision_toolbox_tpu_torch.nn import attention as port_nn_attention
from vision_toolbox_tpu_torch.ops import attention as port_attention
from vision_toolbox_tpu_torch.ops import flash_attention as fa
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DROP = 0.1


def _as_np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.astype(jnp.float32))


def _rel_l2(got, want) -> float:
    got, want = np.ravel(got), np.ravel(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _qkv(seed: int, T: int, S: int, B: int = 2, N: int = 12, H: int = 64):
    """(B, T/S, N, H) f32 numpy; q scaled up for peaked softmax rows."""
    rng = np.random.default_rng(seed)
    r = lambda n: rng.standard_normal((B, n, N, H)).astype(np.float32)
    return 3.0 * r(T), r(S), r(S)


@pytest.mark.parametrize("T,S", [(577, 577), (1, 1024)])
def test_attention_rounds_probabilities_like_jax(T, S):
    q, k, v = _qkv(T, T, S)
    want = jax.nn.dot_product_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = port_attention.dot_product_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert_matches_kernel(_as_np(got), _as_np(want))


class _Masks:
    """Keep masks drawn from a numpy seed in call order, handed to the JAX
    package (as ``jax.random.bernoulli``) and to the port (as its
    ``dropout``); both sides must ask for the same shapes in the same order."""

    def __init__(self, seed: int):
        self.rng, self.jax_shapes, self.port_shapes, self.masks = (
            np.random.default_rng(seed), [], [], [])

    def _mask(self, shape, log):
        i = len(log)
        log.append(tuple(shape))
        while len(self.masks) <= i:
            self.masks.append(None)
        if self.masks[i] is None:
            self.masks[i] = self.rng.random(shape) >= DROP
        assert self.masks[i].shape == tuple(shape), (i, self.masks[i].shape, shape)
        return self.masks[i]

    def bernoulli(self, key, p, shape):
        return jnp.asarray(self._mask(shape, self.jax_shapes))

    def dropout(self, x, p, generator):
        if p == 0.0:
            return x
        keep = torch.from_numpy(self._mask(x.shape, self.port_shapes))
        return x * keep / torch.tensor(1.0 - p, dtype=x.dtype)

    @contextlib.contextmanager
    def patched(self, monkeypatch):
        monkeypatch.setattr(jax.random, "bernoulli", self.bernoulli)
        for module in (port_attention, port_nn_attention, cait):
            monkeypatch.setattr(module, "dropout", self.dropout)
        yield self
        assert self.jax_shapes == self.port_shapes


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_dropout_path_matches_jax_manual_path(monkeypatch, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(5, 50, 50, N=4, H=32)
    with _Masks(0).patched(monkeypatch):
        want = jax_manual_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), dropout_rate=DROP,
                                    dropout_rng=jax.random.PRNGKey(0))
        got = port_attention.dot_product_attention(
            *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), dropout_rate=DROP,
            generator=torch.Generator())
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_as_np(got), _as_np(want), rtol=1e-5, atol=1e-5)
    else:
        assert_matches_kernel(_as_np(got), _as_np(want))


# a narrow CaiT at 96 px with patch 4: T = 576 patch tokens, above K5's 512
CAIT_T576 = dict(d_model=192, sa_depth=1, ca_depth=1, n_heads=4, patch_size=4, img_size=96,
                 layer_scale_init=0.1)


@pytest.fixture
def jax_k3_on(monkeypatch):
    """The JAX CaiT's MLP halves through K3 on the CPU (its attention takes
    the XLA branch off a TPU on its own)."""
    monkeypatch.setattr(jbm, "_FORCE_ON", True)


def _cait_pair(dtype: str, dropout: float = 0.0):
    jdt, tdt = DTYPES[dtype]
    jm = JaxCaiT(**CAIT_T576, dropout=dropout, dtype=jdt)
    params = jax.tree.map(np.asarray, jm.init_variables(0)["params"])
    pm = CaiT(**CAIT_T576, dropout=dropout, dtype=tdt, device="cpu")
    pm.load_state_dict(flax_to_state_dict(params), strict=True)
    return jm, params, pm


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cait_beyond_the_kernels_rule_matches_jax(jax_k3_on, monkeypatch, dtype):
    jm, params, pm = _cait_pair(dtype)
    calls = []
    xla = cait.TalkingHeadAttention._xla_attention
    monkeypatch.setattr(cait.TalkingHeadAttention, "_xla_attention",
                        lambda self, *a, **kw: calls.append(1) or xla(self, *a, **kw))
    x = np.random.default_rng(1).random((2, 96, 96, 3), dtype=np.float32)
    want = _as_np(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert calls == [1] and got.dtype == DTYPES[dtype][1]
    if dtype == "float32":
        assert_matches_kernel(_as_np(got), want, tight=1e-3)
    else:
        assert _rel_l2(_as_np(got), want) <= 1e-2


@pytest.mark.parametrize("dropout", [0.0, DROP], ids=["no-dropout", "attention-dropout"])
def test_cait_training_branch_gradients_match_jax(jax_k3_on, monkeypatch, dropout):
    """Training (train=True) forward and gradients of every parameter, f32;
    with dropout the keep masks of the attention and MLP dropouts are fed to
    both sides."""
    jm, params, pm = _cait_pair("float32", dropout)
    rng = np.random.default_rng(2)
    x = rng.random((2, 96, 96, 3), dtype=np.float32)
    cot = rng.standard_normal((2, 192)).astype(np.float32)
    with _Masks(3).patched(monkeypatch) if dropout else contextlib.nullcontext():
        def loss(p):
            out = jm.apply({"params": p}, jnp.asarray(x), train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.sum(out * cot), out

        (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
        got = pm(torch.from_numpy(x), train=True, generator=torch.Generator())
        (got * torch.from_numpy(cot)).sum().backward()
    assert_matches_kernel(_as_np(got), _as_np(want), tight=1e-3)
    want_grads = {n: t.numpy() for n, t in flax_to_state_dict(jax.tree.map(np.asarray,
                                                                           grads)).items()}
    errs = {n: _rel_l2(_as_np(p.grad), want_grads[n]) for n, p in pm.named_parameters()
            if not n.endswith(("k_proj.bias", "proj_l_bias"))}  # zero in exact arithmetic
    assert max(errs.values()) <= 1e-3, sorted(errs.items(), key=lambda kv: -kv[1])[:4]


@pytest.mark.parametrize("d_model,n_heads,T,dropout,train,xla", [
    (128, 4, 196, 0.0, False, False),  # JAX runs K5: the op (K5 on the card, heads padded)
    (768, 16, 196, 0.0, False, False),  # cait_m at 224 px: only the CUDA rule admits it
    (128, 4, 16, DROP, False, False),  # dropout outside training draws nothing
    (768, 16, 324, 0.0, False, True),  # cait_m at 288 px: neither rule admits it
    (128, 4, 513, 0.0, False, True),
    (68, 17, 16, 0.0, False, True),
    (128, 4, 16, DROP, True, True),
], ids=["head-32", "cait-m-224", "dropout-eval", "cait-m-288", "T-513", "17-heads",
        "dropout-train"])
def test_cait_takes_the_xla_branch_where_jax_does(d_model, n_heads, T, dropout, train, xla):
    """``TalkingHeadAttention`` leaves the talking-head op only where the
    JAX module runs no kernel (T > 512, more than 16 heads, the TPU's VMEM
    budget, dropout in training) and the CUDA kernels' rule does not admit
    the shape either."""
    g = torch.Generator().manual_seed(0)
    m = cait.TalkingHeadAttention(d_model, n_heads, dropout=dropout, generator=g)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cait, "talking_head_attention", lambda *a, **kw: calls.append("op") or a[0])
        mp.setattr(m, "_xla_attention", lambda *a, **kw: calls.append("xla") or a[0])
        out = m(torch.randn(1, T, d_model, generator=g), train=train, generator=g)
    assert calls == ["xla" if xla else "op"] and out.shape == (1, T, d_model)


def _padded(t: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def test_padded_head_plain_equals_unpadded():
    """Head 72 zero-padded to 80 with the scale of 72: the plain forward
    and backward equal the unpadded ones, and the padded columns of the
    output and of dq, dk, dv are zero."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, n, 72, generator=g) for n in (40, 56, 56))
    dout = torch.randn(4, 40, 72, generator=g)
    scale = 72**-0.5
    out, lse = fa.flash_attention_plain(q, k, v)
    pout, plse = fa.flash_attention_plain(*(_padded(t, 80) for t in (q, k, v)), scale=scale)
    torch.testing.assert_close(pout[..., :72], out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(plse, lse, rtol=1e-6, atol=1e-6)
    assert torch.equal(pout[..., 72:], torch.zeros_like(pout[..., 72:]))
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    got = fa.flash_attention_bwd_plain(*(_padded(t, 80) for t in (q, k, v, pout)), plse,
                                       _padded(dout, 80), scale=scale)
    for a, b in zip(got, want):
        torch.testing.assert_close(a[..., :72], b, rtol=1e-6, atol=1e-6)
        assert torch.equal(a[..., 72:], torch.zeros_like(a[..., 72:]))


def test_flash_attention_pads_the_head_in_its_relayout(monkeypatch):
    """Head 72 now reaches the op as it is: ``flash_attention`` hands the
    (B, T, N, 72) operands to ``vtt::flash_attention`` with the scale of 72,
    and the CUDA kernels zero-pad the head to 80 in shared memory (no
    relayout copy). The result and gradients equal the plain versions on the
    head zero-padded to 80, which is what the kernels compute."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 1024, 2, 72, generator=g) for _ in range(3))
    seen = []
    op = fa._flash_attention_op
    monkeypatch.setattr(fa, "_flash_attention_op",
                        lambda *a: seen.append((tuple(a[0].shape), a[-1])) or op(*a))
    with torch.no_grad():
        got = fa.flash_attention(q, k, v)
    assert seen == [((1, 1024, 2, 72), 72**-0.5)]
    padded = lambda t: _padded(t.transpose(1, 2).reshape(2, 1024, 72), 80)
    unflat = lambda t: t[..., :72].reshape(1, 2, 1024, 72).transpose(1, 2)
    pout, plse = fa.flash_attention_plain(*(padded(t) for t in (q, k, v)), scale=72**-0.5)
    torch.testing.assert_close(got, unflat(pout), rtol=1e-6, atol=1e-6)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    dout = torch.randn(1, 1024, 2, 72, generator=g)
    grads = torch.autograd.grad(fa.flash_attention(*leaves), leaves, dout)
    want = fa.flash_attention_bwd_plain(*(padded(t) for t in (q, k, v)), pout, plse, padded(dout),
                                        scale=72**-0.5)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, unflat(b), rtol=1e-5, atol=1e-6)
