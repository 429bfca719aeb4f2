"""The port's fused half-block gates (``use_fused_attention``,
``use_fused_mlp``) against the JAX package's rules.

The port's K3/K4 gates are the JAX rules without their TPU test, and the
CUDA kernels' own shape terms. So at every shape both admit, the port runs
the fused half-block's rounding (bf16 y, q, k, v, p, o, h, g), and at every
shape JAX refuses, the port runs the module chain in the model's type, as
JAX runs XLA there. Two checks: a narrow-depth vit_ti_16 (d_model 192, which
JAX's K4 rule refuses: d_model % 128) in f32 against the JAX model with its
K3/K4 forced on; and every registered name at its default size, its blocks'
gate calls recorded on the meta device and held to the JAX rules with
``_FORCE_ON`` patched (the shape terms only).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import assert_matches_kernel

import vision_toolbox_tpu.ops.block_attention as jba
import vision_toolbox_tpu.ops.block_mlp as jbm
from vision_toolbox_tpu.models.deit import DeiT as JaxDeiT
from vision_toolbox_tpu.models.vit import ViT as JaxViT
from vision_toolbox_tpu_torch import create_backbone, list_backbones
from vision_toolbox_tpu_torch.models import cait, convnext, deit, swin, vit
from vision_toolbox_tpu_torch.models.deit import DeiT
from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.ops import block_attention, block_mlp
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

# vit_ti_16 / deit_ti_16 at full width and 224 px, depth cut to 2: with the
# port's earlier gate (d_model % 64) the port ran K4's bf16 chain there and
# only 31% of the outputs lay within 1e-3 (max abs 1.3e-2)
TI = dict(d_model=192, depth=2, n_heads=3, patch_size=16, img_size=224)
FAMILIES = {"vit_ti_16": (JaxViT, ViT), "deit_ti_16": (JaxDeiT, DeiT)}
# every name runs at 224 px but swin_s3-s: its 14-token windows need a 14×14
# last stage, so 448 px (at 224 px neither package runs it)
IMG_SIZE = {"swin_s3-s": 448}
# families without fused half-blocks: their gates are never asked
NO_FUSED_BLOCKS = ("convnextv2", "patchconvnet", "vovnet", "efficientnet", "mobilenet_v3",
                   "resnet", "resnext", "wide_resnet", "regnet")


@pytest.fixture
def jax_fused_on(monkeypatch):
    monkeypatch.setattr(jba, "_FORCE_ON", True)
    monkeypatch.setattr(jbm, "_FORCE_ON", True)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ti_forward_matches_jax_with_its_kernels_forced_on(jax_fused_on, family):
    """f32, JAX's init carried over strictly: JAX refuses K4 at d_model 192
    and runs its attention in f32, K3 in interpret mode; the port's blocks
    take the module chain for attention and K3's plain version. The model
    parity rule: ≥ 75% within 1e-3, all within 1e-2 (tests/torch_parity.py)."""
    jax_cls, port_cls = FAMILIES[family]
    jm = jax_cls(**TI)
    variables = jax.jit(lambda: jm.init_variables(0))()
    pm = port_cls(**TI, device="cpu")
    pm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables["params"])),
                       strict=True)
    x = np.random.default_rng(1).random((2, 224, 224, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 192)
    assert_matches_kernel(got, want, tight=1e-3)
    assert not block_attention.use_fused_attention(192, 3, 197, 0.0, True)


@pytest.fixture
def gate_calls(monkeypatch):
    """Records every call of the port's two gates (arguments and answer);
    the models build on the meta device without being moved."""
    calls = []
    for module, name in ((block_attention, "use_fused_attention"), (block_mlp, "use_fused_mlp")):
        rule = getattr(module, name)

        def record(*args, _rule=rule, _name=name, **kw):
            calls.append((_name, args, kw, _rule(*args, **kw)))
            return calls[-1][-1]

        monkeypatch.setattr(module, name, record)
    for module in (vit, deit, cait, convnext, swin):
        monkeypatch.setattr(module, "to_device", lambda model, device: None)
    return calls


@pytest.mark.parametrize("name", list_backbones())
def test_gates_are_the_jax_rules_at_every_registered_shape(gate_calls, monkeypatch, name):
    """A meta-device forward of ``name`` at 224 px (``IMG_SIZE``) records each
    block's gate calls; each answer equals the JAX rule's on the same
    shape with ``_FORCE_ON`` patched (its TPU test lifted). Darknets,
    ConvNeXt v2 (GRN sits inside the MLP), PatchConvNet, VoVNet and the
    MBConv nets, ResNets and RegNets have no fused blocks and record
    none."""
    monkeypatch.setattr(jba, "_FORCE_ON", True)
    monkeypatch.setattr(jbm, "_FORCE_ON", True)
    with torch.device("meta"), torch.no_grad():
        img = IMG_SIZE.get(name, 224)
        kw = {} if img == 224 else dict(img_size=img)
        model = create_backbone(name, device="meta", **kw)
        model(torch.empty(2, img, img, 3))
    jax_rule = {"use_fused_attention": jba.use_fused_attention, "use_fused_mlp": jbm.use_fused_mlp}
    seen = {(gate, args, tuple(sorted(kw.items()))): got for gate, args, kw, got in gate_calls}
    differ = {call: got for call, got in seen.items()
              if got != jax_rule[call[0]](*call[1], **dict(call[2]))}
    assert not differ, f"{name}: the port's gate differs from the JAX rule at {differ}"
    if "darknet" in name or name.startswith(NO_FUSED_BLOCKS):
        assert not seen
    else:
        assert any(gate == "use_fused_mlp" for gate, *_ in seen), name
