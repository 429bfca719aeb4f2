"""The port's Swin window attention (vision_toolbox_tpu_torch/ops/swin_attention.py,
K7) vs the JAX kernel (vision_toolbox_tpu/ops/swin_attention.py) in interpret
mode.

The plain PyTorch versions (what the port runs on CPU tensors and holds its
CUDA kernels against on the card) are held against ``swin_window_attention``
forward and its VJP (dq, dk, dv and the dPE sum over batch and windows), with
and without the shift mask, in f32 and bf16: one JAX forward and VJP per
(mask, dtype), shared by the cases that read its tensors. Both sides compute
in f32 from the inputs and round the outputs once, so f32 agrees to 1e-5
(summation order) and bf16 by tests/torch_parity.py's rule (rounding flips).

With attention dropout in training, ``WindowAttention`` runs the JAX
module's einsum path: held against the JAX module, whose own dispatch takes
that path, with the same keep masks fed to both sides (JAX's
``jax.random.bernoulli`` and the port's ``dropout`` patched to read one
numpy stream). f32 to 1e-5, bf16 by rel L2 ≤ 1e-2.
"""

import functools

import numpy as np
import pytest
import torch
from torch_parity import assert_matches_kernel

import jax
import jax.numpy as jnp

from vision_toolbox_tpu.models.swin import WindowAttention as JaxWindowAttention
from vision_toolbox_tpu.ops.swin_attention import swin_window_attention as jax_swin_attention
from vision_toolbox_tpu_torch.models import swin
from vision_toolbox_tpu_torch.ops import _cuda
from vision_toolbox_tpu_torch.ops import swin_attention as sa
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (B, nW, T, N, hd): window 4 (T = 16), four windows, two 16-wide heads
SHAPE = (2, 4, 16, 2, 16)
DROP = 0.1


def _inputs(masked: bool):
    """q, k, v, the output cotangent (B, nW, T, N·hd), pe (1, N, T, T) and
    the mask (nW, T, T) or None, f32 numpy."""
    B, nW, T, N, hd = SHAPE
    rng = np.random.default_rng(7 + masked)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    q, k, v, g = (r(B, nW, T, N * hd, scale=2.0 if i == 0 else 1.0) for i in range(4))
    pe = r(1, N, T, T, scale=0.5)
    mask = ((rng.random((nW, T, T)) < 0.3) * -100.0).astype(np.float32) if masked else None
    return q, k, v, g, pe, mask


@functools.lru_cache(maxsize=None)
def _jax_side(masked: bool, dtype: str):
    """The JAX kernel's output and (dq, dk, dv, dpe), as f32 numpy."""
    jdt = DTYPES[dtype][0]
    q, k, v, g, pe, mask = _inputs(masked)
    cast = lambda a: None if a is None else jnp.asarray(a).astype(jdt)
    jmask = cast(mask)
    out, vjp = jax.vjp(lambda q, k, v, pe: jax_swin_attention(q, k, v, pe, jmask, SHAPE[3]),
                       *map(cast, (q, k, v, pe)))
    return tuple(np.asarray(t.astype(jnp.float32)) for t in (out, *vjp(cast(g))))


def _port_side(masked: bool, dtype: str):
    """The port's plain forward and its autograd gradients, as f32 numpy."""
    tdt = DTYPES[dtype][1]
    q, k, v, g, pe, mask = _inputs(masked)
    cast = lambda a: None if a is None else torch.from_numpy(a).to(tdt)
    leaves = [cast(a).requires_grad_() for a in (q, k, v, pe)]
    out = sa.swin_window_attention(*leaves, cast(mask), SHAPE[3])
    out.backward(cast(g))
    assert out.dtype == tdt and all(t.grad.dtype == tdt for t in leaves)
    return tuple(t.detach().float().numpy() for t in (out, *(t.grad for t in leaves)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("i,name", list(enumerate(["out", "dq", "dk", "dv", "dpe"])))
def test_plain_versions_match_the_jax_kernel(masked, dtype, i, name):
    got, want = _port_side(masked, dtype)[i], _jax_side(masked, dtype)[i]
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5, atol=1e-5)
    elif name == "dpe":  # an f32 sum over 8 window-images, rounded to bf16 once
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
    else:
        assert_matches_kernel(got / scale, want / scale)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_second_plane_controls_lie_farther_from_the_jax_kernel(masked):
    """bf16: the forward's control ``swin_attention_one_plane`` (p rounded to
    bf16 once before p·v) and the backward's ``swin_attention_bwd_one_plane``
    (p rounded before dv, ds before dq and dk) against the JAX kernel in
    interpret mode: the plain twins lie at most half as far (rel L2), the rule
    that lets the card's control refuse a kernel that drops p's or ds's
    second plane."""
    want = _jax_side(masked, "bfloat16")
    q, k, v, g, pe, mask = (None if a is None else torch.from_numpy(a).to(torch.bfloat16)
                            for a in _inputs(masked))
    N = SHAPE[3]
    twin = (sa.swin_attention_plain(q, k, v, pe, mask, N),
            *sa.swin_attention_bwd_plain(q, k, v, pe, mask, N, g)[:3])
    control = (sa.swin_attention_one_plane(q, k, v, pe, mask, N),
               *sa.swin_attention_bwd_one_plane(q, k, v, pe, mask, N, g)[:3])
    for name, a, b, w in zip(("out", "dq", "dk", "dv"), twin, control, want):
        err = lambda t: float(np.linalg.norm(t.float().numpy() - w) / np.linalg.norm(w))
        assert err(a) <= 0.5 * err(b), (name, err(a), err(b))


@pytest.mark.parametrize("t,s,hd,admitted", [
    (49, 49, 32, True),     # window 7: every registered Swin's heads
    (196, 196, 32, True),   # window 14: the S3 variants
    (256, 256, 128, True),  # the JAX package's MAX_WINDOW_SEQ, the kernels' widest head
    (16, 16, 20, True),
    (257, 257, 32, False),
    (49, 64, 32, False),
    (49, 49, 160, False),
])
def test_gate_is_the_kernels_shape_rule(t, s, hd, admitted):
    assert sa.use_swin_kernel(t, s, hd) is admitted


def test_custom_op_runs_the_plain_version_on_cpu():
    """Without gradients the entry point runs ``vtt::swin_window_attention``;
    on CPU tensors that is the plain version, and it launches no kernel."""
    q, k, v, _, pe, mask = (None if a is None else torch.from_numpy(a)
                            for a in _inputs(True))
    before = dict(_cuda.LAUNCHES)
    with torch.no_grad():
        got = sa.swin_window_attention(q, k, v, pe, mask, SHAPE[3])
    assert torch.equal(got, torch.ops.vtt.swin_window_attention(q, k, v, pe, mask, SHAPE[3]))
    assert torch.equal(got, sa.swin_attention_plain(q, k, v, pe, mask, SHAPE[3]))
    assert _cuda.LAUNCHES == before


def test_windows_per_block_covers_every_window():
    """The kernels' blocks take one window index of a run of consecutive
    images and cover each image once, for each kernel route: (B, nW, heads)
    at swin_t's four stages at batch 128, window 14, one image, and more heads
    than the card has blocks. The CUDA-core kernels keep the card's eight
    blocks an SM (at window 14, batch 128: two images a block, 768 blocks),
    the large-window register tiles take two (six images a block)."""
    routes = (sa.ROUTE_CORES, sa.ROUTE_SMALL, sa.ROUTE_LARGE)
    for batch, n_windows, heads in ((128, 64, 3), (128, 16, 6), (128, 4, 12), (128, 1, 24),
                                    (128, 1, 12), (1, 1, 1), (7, 1, 2000), (3, 64, 3)):
        for route in routes:
            per = sa.windows_per_block(batch, n_windows, heads, route)
            runs = -(-batch // per)
            assert 1 <= per <= batch and (runs - 1) * per < batch <= runs * per
    assert [sa.windows_per_block(128, 1, 12, r) for r in routes] == [2, 2, 6]


class _Masks:
    """Keep masks from one numpy stream in call order, handed to the JAX
    package (as ``jax.random.bernoulli``) and to the port (as its
    ``dropout``)."""

    def __init__(self, seed: int):
        self.rng, self.shapes = np.random.default_rng(seed), {"jax": [], "port": []}
        self.masks = []

    def _mask(self, shape, side):
        log = self.shapes[side]
        log.append(tuple(shape))
        if len(self.masks) < len(log):
            self.masks.append(self.rng.random(shape) >= DROP)
        return self.masks[len(log) - 1]

    def bernoulli(self, key, p, shape):
        return jnp.asarray(self._mask(shape, "jax"))

    def dropout(self, x, p, generator):
        keep = torch.from_numpy(self._mask(x.shape, "port"))
        return x * keep / torch.tensor(1.0 - p, dtype=x.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dropout_path_matches_the_jax_einsum_path(monkeypatch, dtype):
    """A shifted window-attention layer (8×8 map, window 4, two heads of 16)
    in training with attention dropout 0.1: the port's einsum path against
    the JAX module's, one set of keep masks, parameters through the bridge."""
    jdt, tdt = DTYPES[dtype]
    jm = JaxWindowAttention(8, 32, 2, 4, shift=True, dropout=DROP, dtype=jdt)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 32)).astype(np.float32)
    params = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 32))))()
    params = jax.tree.map(np.asarray, params["params"])
    pm = swin.WindowAttention(8, 32, 2, 4, shift=True, dropout=DROP, dtype=tdt,
                              generator=torch.Generator())
    pm.load_state_dict(flax_to_state_dict(params), strict=True)
    masks = _Masks(0)
    monkeypatch.setattr(jax.random, "bernoulli", masks.bernoulli)
    monkeypatch.setattr(swin, "dropout", masks.dropout)
    want = jm.apply({"params": params}, jnp.asarray(x).astype(jdt), train=True,
                    rngs={"dropout": jax.random.PRNGKey(1)})
    calls = []
    monkeypatch.setattr(swin, "swin_window_attention", lambda *a, **kw: calls.append(a))
    got = pm(torch.from_numpy(x).to(tdt), train=True, generator=torch.Generator())
    assert masks.shapes["jax"] == masks.shapes["port"] == [(2, 4, 2, 16, 16)] and not calls
    got, want = got.detach().float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
