"""Int8 serving (``utils/int8_serving.py``) against the JAX package's
``quantize_params`` / ``quantized_apply``.

- Selection: vit_ti_16 at 64 px with the JAX package's initial variables
  bridged into the port: the quantized modules are exactly the JAX
  ``qtree``'s keys (every q/k/v, out and MLP projection of the 12 blocks,
  72), and ``w8`` and ``scale`` are bit-equal to JAX's (0 elements differ:
  both divide exactly, the weights' absmax / 127 included).
- Logits: the quantized port against the jitted JAX ``quantized_apply`` on
  the same weights and images, and mean |int8 − f32| / mean |f32| < 0.05
  (the JAX test's bound). Both round x to int8 at the same points, so they
  differ only where the f32 input of a quantized product lies within f32
  noise of a .5 boundary and one x8 element flips. vit_ti_16 has none: max
  abs ≤ INT8_VS_JAX (measured 8.3e-7, outputs of ~1; the JAX apply run op
  by op differs from its own jitted program by 1.2e-2 from such flips). A
  narrow Mixer (196 tokens) runs its token halves with k = 196 and n =
  196, both padded to 200 for ``torch._int_mm``; it has one flip (1 of
  25,088 x8 elements of block 0's channel linear1, whose LayerNorm output
  differs by 1.7e-6 from the summation order), rel L2 to JAX ≤
  INT8_FLIP_REL_L2 (measured 3.9e-4; its int8 error from f32 is 3.8e-3).
- The int32 product is exact at every padded shape; the quantized model
  keeps its fused half-blocks off (their kernels read float weights); the
  original model is untouched; the quantized model exports, and the loaded
  program runs one int8 product a quantized module and no float product,
  with the batch free (a MAP-pooled ViT's probe has batch-many rows, padded
  to 17 below that).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vision_toolbox_tpu import create_backbone as jax_create_backbone
from vision_toolbox_tpu.models.mlp_mixer import MLPMixer as JaxMLPMixer
from vision_toolbox_tpu.utils.int8_serving import quantize_params, quantized_apply
from vision_toolbox_tpu_torch import create_backbone
from vision_toolbox_tpu_torch.models import MLPMixer, ViT
from vision_toolbox_tpu_torch.nn.layers import Linear
from vision_toolbox_tpu_torch.ops import block_attention, block_mlp
from vision_toolbox_tpu_torch.utils import int8_serving
from vision_toolbox_tpu_torch.utils.export import export_model, load_exported
from vision_toolbox_tpu_torch.utils.int8_serving import Int8Linear, int8_matmul, quantize_model
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

INT8_VS_JAX = 1e-5
INT8_FLIP_REL_L2 = 1e-3
INT8_VS_F32 = 0.05


def _port_name(key: str) -> str:
    """A JAX qtree key ("block_3/mha/q_proj") as the port's module name."""
    return re.sub(r"block_(\d+)", r"blocks.\1", key).replace("/", ".")


@pytest.fixture(scope="module")
def vit_ti():
    """vit_ti_16 at 64 px: the JAX model, its variables and qtree, the port
    model with the same weights, and images."""
    jax_model = jax_create_backbone("vit_ti_16", img_size=64)
    variables = jax_model.init_variables(0, 64)
    model = create_backbone("vit_ti_16", img_size=64, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    x = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    return jax_model, variables, quantize_params(variables["params"]), model, x


def _int8_modules(model):
    return {n: m for n, m in model.named_modules() if isinstance(m, Int8Linear)}


def test_selection_and_weights_match_jax(vit_ti):
    _, _, qtree, model, _ = vit_ti
    mods = _int8_modules(quantize_model(model))
    assert len(mods) == len(qtree) == 72
    assert set(mods) == {_port_name(k) for k in qtree}
    for key, (w8, scale, bias) in qtree.items():
        m = mods[_port_name(key)]
        assert m.w8.dtype == torch.int8 and m.scale.dtype == m.bias.dtype == torch.float32
        np.testing.assert_array_equal(m.w8.numpy(), np.asarray(w8).T)
        np.testing.assert_array_equal(m.scale.numpy(), np.asarray(scale))
        np.testing.assert_array_equal(m.bias.numpy(), np.asarray(bias))


def test_logits_match_jax_and_stay_near_f32(vit_ti):
    jax_model, variables, qtree, model, x = vit_ti
    want = jax.jit(lambda q, v, x: quantized_apply(jax_model, q, v, x))(qtree, variables,
                                                                        jnp.asarray(x))
    with torch.no_grad():
        got = quantize_model(model)(torch.from_numpy(x)).numpy()
        f32 = model(torch.from_numpy(x), force_unfused=True).numpy()
    assert np.abs(got - np.asarray(want)).max() <= INT8_VS_JAX
    assert not np.allclose(got, f32)
    assert np.abs(got - f32).mean() / np.abs(f32).mean() < INT8_VS_F32


def test_narrow_mixer_pads_its_token_halves(monkeypatch):
    """MLPMixer(2 layers, d 64, patch 8, 112 px): 196 tokens, the token
    halves' Linears (196 → 32 → 196) quantized, k = 196 and n = 196 padded."""
    jax_model = JaxMLPMixer(n_layers=2, d_model=64, patch_size=8, img_size=112)
    x = np.random.default_rng(1).random((2, 112, 112, 3), dtype=np.float32)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    qtree = quantize_params(variables["params"])
    model = MLPMixer(2, 64, 8, 112, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    quantized = quantize_model(model)
    assert set(_int8_modules(quantized)) == {_port_name(k) for k in qtree}
    shapes = []
    real = int8_serving.int8_matmul
    monkeypatch.setattr(int8_serving, "int8_matmul",
                        lambda x8, w8: shapes.append((x8.shape, w8.shape)) or real(x8, w8))
    with torch.no_grad():
        got = quantized(torch.from_numpy(x)).numpy()
        f32 = model(torch.from_numpy(x), force_unfused=True).numpy()
    assert ((128, 196), (32, 196)) in shapes and ((128, 32), (196, 32)) in shapes
    want = np.asarray(jax.jit(lambda q, v, x: quantized_apply(jax_model, q, v, x))(
        qtree, variables, jnp.asarray(x)))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= INT8_FLIP_REL_L2
    assert np.abs(got - f32).mean() / np.abs(f32).mean() < INT8_VS_F32


@pytest.mark.parametrize("M,K,N", [(1, 196, 384), (16, 768, 768), (17, 8, 8), (40, 196, 196),
                                   (5, 3, 5), (300, 384, 196)])
def test_int8_matmul_is_exact(M, K, N):
    g = torch.Generator().manual_seed(M + K + N)
    x8 = torch.randint(-127, 128, (M, K), dtype=torch.int8, generator=g)
    w8 = torch.randint(-127, 128, (N, K), dtype=torch.int8, generator=g)
    got = int8_matmul(x8, w8)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.long(), x8.long() @ w8.long().t())


def test_quantized_blocks_leave_the_fused_kernels(vit_ti, monkeypatch):
    *_, model, x = vit_ti
    quantized = quantize_model(model)

    def refuse(*a, **k):
        raise AssertionError("a quantized block reached a fused half-block")

    monkeypatch.setattr(block_attention, "fused_attention_block", refuse)
    monkeypatch.setattr(block_mlp, "fused_mlp_block", refuse)
    with torch.no_grad():
        quantized(torch.from_numpy(x))
    convnext = quantize_model(create_backbone("convnext_t", device="cpu"))
    swin = quantize_model(create_backbone("swin_t", device="cpu"))
    assert not any(b.fused_at(56 * 56) for s in convnext.stages for b in s)
    assert not any(b.fused_at(56 * 56) for s in swin.stages for b in s)


def test_original_model_is_untouched(vit_ti):
    *_, model, _ = vit_ti
    before = {k: v.clone() for k, v in model.state_dict().items()}
    quantize_model(model, min_size=1)
    assert not _int8_modules(model)
    assert all(isinstance(m.mha.q_proj, Linear) for m in model.blocks)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


class _Products(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._schema.name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("pool_type", ["cls_token", "mha"])
def test_quantized_model_exports_and_serves(pool_type):
    model = ViT(64, 2, 4, 8, 32, cls_token=pool_type == "cls_token", pool_type=pool_type,
                device="cpu")
    quantized = quantize_model(model)
    n_q = len(_int8_modules(quantized))
    assert n_q == 2 * 6 + (6 if pool_type == "mha" else 0)
    served = load_exported(export_model(quantized, (8, 32, 32, 3)))
    for b in (1, 3, 20):
        x = torch.rand(b, 32, 32, 3, generator=torch.Generator().manual_seed(b))
        with torch.no_grad(), _Products() as p:
            out = served(x)
        with torch.no_grad():
            eager = quantized(x)
        torch.testing.assert_close(out, eager, rtol=0, atol=0)
        assert p.names.count("aten::_int_mm") == n_q
        assert not {"aten::mm", "aten::addmm", "aten::linear"} & set(p.names)
