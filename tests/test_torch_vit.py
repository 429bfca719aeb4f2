"""The port's ViT (vision_toolbox_tpu_torch/models/vit.py) vs the JAX ViT.

A tiny ViT (D=128, 4 heads, depth 2, patch 8, 32 px: T = 16 patches + cls)
is initialised by the JAX package, its params go through
``utils/jax_bridge.py`` into the port, and the same numpy images go through
both, for each pool type.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn
from torch_parity import assert_matches_kernel

import vision_toolbox_tpu.ops.block_attention as ba
import vision_toolbox_tpu.ops.block_mlp as bm
from vision_toolbox_tpu.models.vit import ViT as JaxViT
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.nn.layers import LayerNorm
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

TINY = dict(d_model=128, depth=2, n_heads=4, patch_size=8, img_size=32)
POOLS = {"cls_token": {}, "gap": {"pool_type": "gap"},
         "mha": {"pool_type": "mha", "cls_token": False}}


def _pair(pool: str, seed: int = 0):
    kw = {**TINY, **POOLS[pool]}
    jm = JaxViT(**kw)
    variables = jm.init_variables(seed)
    pm = ViT(**kw)
    pm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables["params"])))
    x = np.random.default_rng(seed + 1).random((3, 32, 32, 3), dtype=np.float32)
    return jm, variables, pm, x


@pytest.fixture
def jax_fused_on(monkeypatch):
    monkeypatch.setattr(ba, "_FORCE_ON", True)
    monkeypatch.setattr(bm, "_FORCE_ON", True)


@pytest.mark.parametrize("pool", list(POOLS))
def test_vit_fused_matches_jax_fused(jax_fused_on, pool):
    """Both sides through the fused half-blocks: the JAX kernels in interpret
    mode, the port's ops through their plain versions on CPU. Same rounding
    points, f32 sums in another order; a bf16 rounding that flips in block 1
    carries through block 2 and the final LayerNorm, so the tight share is
    held at 1e-3 and every element at the bf16-flip bound
    (tests/torch_parity.py)."""
    jm, variables, pm, x = _pair(pool)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 128)
    assert_matches_kernel(got, want, tight=1e-3)


@pytest.mark.parametrize("pool", ["cls_token", "mha"])
def test_vit_bf16_matches_jax_bf16(jax_fused_on, pool):
    """Serving dtype: both models in bf16 through the fused half-blocks.
    The residual stream is rounded to bf16 after every half-block on both
    sides, so a summation-order flip moves an output by a bf16 ulp (measured
    ≤ 2e-2 abs, rel L2 ≤ 6e-3 over 12 seeds × pools); held to rel L2 ≤ 1e-2,
    the bound chip_smoke.py holds the bf16 vit_b_16 logits to."""
    kw = {**TINY, **POOLS[pool]}
    jm = JaxViT(**kw, dtype=jnp.bfloat16)
    variables = jm.init_variables(2)
    pm = ViT(**kw, dtype=torch.bfloat16)
    pm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables["params"])))
    x = np.random.default_rng(3).random((3, 32, 32, 3), dtype=np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def _trained_layernorms(params, seed):
    """Every LayerNorm ``scale`` → 1 + 0.01·N(0, 1), ``bias`` → 0.01·N(0, 1):
    values bf16 does not hold exactly."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        keys = [getattr(k, "key", str(k)) for k in path]
        a = np.asarray(a)
        if len(keys) > 1 and "norm" in keys[-2] and keys[-1] in ("scale", "bias"):
            return ((keys[-1] == "scale") + 0.01 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


def _jax_layernorm_calls(jm, params, x):
    """(module path, input, output) of every flax LayerNorm the model runs."""
    calls = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, flax_nn.LayerNorm) and context.method_name == "__call__":
            calls.append((context.module.path, np.asarray(args[0].astype(jnp.float32)),
                          np.asarray(out.astype(jnp.float32))))
        return out

    with flax_nn.intercept_methods(record):
        out = jm.apply({"params": params}, jnp.asarray(x))
    return np.asarray(out.astype(jnp.float32)), calls


@pytest.mark.parametrize("path", ["fused", "unfused"])
@pytest.mark.parametrize("pool", ["cls_token", "mha"])
def test_vit_bf16_trained_layernorms_match_jax(monkeypatch, pool, path):
    """bf16 ViT with LayerNorm parameters that bf16 does not hold: the port
    keeps them f32 and applies them in f32 as flax does (the final ``norm``,
    the MAP pooler's ``norm`` and, on the unfused path, the block norms), and
    rounds them to bf16 where the fused kernels take them, as the JAX package
    does. Each LayerNorm the JAX model runs is fed its JAX input on the port
    side: ≥ 99% of outputs bit-equal and all within one bf16 ulp (f32 sums
    in another order; measured all equal, where bf16 parameters leave ~25%
    off by an ulp). The whole model stays within the rel L2 bound of
    ``test_vit_bf16_matches_jax_bf16``."""
    if path == "fused":
        monkeypatch.setattr(ba, "_FORCE_ON", True)
        monkeypatch.setattr(bm, "_FORCE_ON", True)
    kw = {**TINY, **POOLS[pool]}
    jm = JaxViT(**kw, dtype=jnp.bfloat16)
    params = _trained_layernorms(jm.init_variables(2)["params"], seed=4)
    pm = ViT(**kw, dtype=torch.bfloat16)
    pm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    assert all(m.weight.dtype == torch.float32 for m in pm.modules() if isinstance(m, LayerNorm))
    x = np.random.default_rng(3).random((3, 32, 32, 3), dtype=np.float32)
    want, calls = _jax_layernorm_calls(jm, params, x)
    names = {"fused": [("norm",)], "unfused": [("norm",), ("block_0", "mha_norm"),
                                               ("block_1", "mlp_norm")]}[path]
    if pool == "mha":
        names.append(("pooler", "norm"))
    assert set(names) <= {c[0] for c in calls}

    for jpath, inp, out in calls:
        module = pm.get_submodule(".".join(
            f"blocks.{p[6:]}" if p.startswith("block_") else p for p in jpath))
        with torch.no_grad():
            got = module(torch.tensor(inp).to(torch.bfloat16)).float().numpy()
        assert np.mean(got == out) >= 0.99, (jpath, np.mean(got == out))
        np.testing.assert_allclose(got, out, rtol=2.0**-7, atol=0, err_msg=str(jpath))  # 1 ulp

    with torch.no_grad():
        got = pm(torch.from_numpy(x), force_unfused=path == "unfused").float().numpy()
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("pool", list(POOLS))
def test_vit_unfused_matches_jax_unfused(pool):
    """Both sides on the unfused f32 chain (exact-erf GELU, f32 matmuls, no
    bf16 rounding): only f32 summation order differs, so 1e-4."""
    jm, variables, pm, x = _pair(pool, seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), force_unfused=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bridge_covers_every_parameter():
    """The bridged JAX tree loads strictly (same names and shapes) for
    every pool type and for LayerScale blocks."""
    for kw in [*POOLS.values(), {"layer_scale_init": 0.1}]:
        kw = {**TINY, **kw}
        params = JaxViT(**kw).init_variables(0)["params"]
        sd = flax_to_state_dict(jax.tree.map(np.asarray, params))
        ViT(**kw).load_state_dict(sd, strict=True)


def test_registry_names_and_shapes():
    names = [n for n in list_backbones() if n.startswith("vit_")]
    assert names == sorted(
        f"vit_{v}" for v in ("ti_16", "s_32", "s_16", "m_16", "b_32", "b_16", "l_16", "h_14")
    )
    m = create_backbone("vit_ti_16", img_size=32)
    assert m.last_out_channels == 192
    assert len(m.blocks) == 12
    with torch.no_grad():
        assert m(torch.zeros(2, 32, 32, 3)).shape == (2, 192)
    assert create_backbone("vit_b_16").pe.shape == (1, 196, 768)


def test_seeded_init_is_reproducible():
    a = ViT(**TINY, generator=torch.Generator().manual_seed(3))
    b = ViT(**TINY, generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def test_bf16_model_runs_fused_path():
    m = ViT(**TINY, dtype=torch.bfloat16)
    x = torch.rand(2, 32, 32, 3)
    with torch.no_grad():
        out = m(x)
        plain = m(x, plain=True)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert torch.equal(out, plain)  # on CPU the ops run their plain versions
