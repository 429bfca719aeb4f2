"""The port's DeiT and DeiT3 (vision_toolbox_tpu_torch/models/deit.py) vs the
JAX package's: the registry names, strict loading of bridged variables (the
dist token included), and the forward of narrow models through the fused
half-blocks on both sides (the JAX kernels in interpret mode with the fused
path forced on, as tests/test_torch_vit.py does). DeiT3's blocks carry
LayerScale, so its forward runs the γ_ls branch of both kernels. Tolerance
as tests/test_torch_vit.py: ≥ 75% of elements within 1e-3 and all within
the bf16-flip bound (tests/torch_parity.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import assert_matches_kernel

import vision_toolbox_tpu as jvtt
import vision_toolbox_tpu.ops.block_attention as ba
import vision_toolbox_tpu.ops.block_mlp as bm
from vision_toolbox_tpu.models.deit import DeiT as JaxDeiT
from vision_toolbox_tpu.models.vit import ViT as JaxViT
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models.deit import DeiT
from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

TINY = dict(d_model=128, depth=2, n_heads=4, patch_size=8, img_size=32)
MODELS = {"deit": (JaxDeiT, DeiT, {}), "deit3": (JaxViT, ViT, {"layer_scale_init": 0.1})}
VARIANTS = ("ti_16", "s_16", "b_16", "l_16", "h_14")


@pytest.fixture
def jax_fused_on(monkeypatch):
    monkeypatch.setattr(ba, "_FORCE_ON", True)
    monkeypatch.setattr(bm, "_FORCE_ON", True)


def test_registry_names_match_jax():
    names = [n for n in list_backbones() if n.startswith("deit")]
    want = sorted(f"{f}_{v}" for f in ("deit", "deit3") for v in VARIANTS)
    assert names == want
    assert want == sorted(n for n in jvtt.list_backbones() if n.startswith("deit"))
    m = create_backbone("deit3_s_16", img_size=32, device="cpu")
    assert m.last_out_channels == 384 and len(m.blocks) == 12
    assert all(b.mlp_scale is not None for b in m.blocks)  # LayerScale 1e-6
    assert float(m.blocks[0].mha_scale.gamma[0].detach()) == pytest.approx(1e-6)
    d = create_backbone("deit_ti_16", img_size=32, device="cpu")
    assert isinstance(d, DeiT) and d.dist_token.shape == (1, 1, 192)
    with torch.no_grad():
        assert d(torch.zeros(2, 32, 32, 3)).shape == (2, 192)


@pytest.mark.parametrize("family", list(MODELS))
def test_bridge_loads_strictly(family):
    jax_cls, port_cls, kw = MODELS[family]
    params = jax_cls(**TINY, **kw).init_variables(0)["params"]
    sd = flax_to_state_dict(jax.tree.map(np.asarray, params))
    result = port_cls(**TINY, **kw, device="cpu").load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


@pytest.mark.parametrize("family", list(MODELS))
def test_forward_matches_jax(jax_fused_on, family):
    jax_cls, port_cls, kw = MODELS[family]
    jm = jax_cls(**TINY, **kw)
    variables = jm.init_variables(1)
    rng = np.random.default_rng(2)  # non-zero cls/dist tokens, so their paths matter
    params = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
                          .astype(np.float32), variables["params"])
    pm = port_cls(**TINY, **kw, device="cpu")
    pm.load_state_dict(flax_to_state_dict(params), strict=True)
    x = rng.random((3, 32, 32, 3), dtype=np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 128)
    assert_matches_kernel(got, want, tight=1e-3)
