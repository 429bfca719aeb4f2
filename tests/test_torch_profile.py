"""The profiler (``utils/profile.py``) against the JAX package's and against
the port's own plain paths.

- ``count_params`` equals the JAX ``count_params`` of the same model's
  parameters (BatchNorm statistics are buffers here and ``batch_stats``
  there), read off a meta-device build and ``jax.eval_shape`` of the init.
- The ``vtt::`` ops' flop formulas: each op counts what ``FlopCounterMode``
  counts for its plain PyTorch version on the same inputs (the relayouts
  0); the depthwise conv, whose plain version sums elementwise taps that the
  counter does not see, counts what it counts for the grouped convolution
  computing the same function.
- Model level: the kernel path's count equals the plain path's for ViT,
  CaiT, Swin and ConvNeXt (ConvNeXt's depthwise taps added as that grouped
  convolution).
- The gap to the JAX package's count (XLA's cost analysis, which also
  counts elementwise work: LayerNorms, GELU, softmax, residual adds) at
  vit_ti_16, 64 px, batch 1: XLA 0.198964272 GFLOPs, the port 0.18786816
  (its products: patch embedding, projections, attention, MLPs), a gap of
  11,096,112 FLOPs, held exactly.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from vision_toolbox_tpu import create_backbone as jax_create_backbone
from vision_toolbox_tpu.utils.profile import count_params as jax_count_params
from vision_toolbox_tpu.utils.profile import flops as jax_flops
from vision_toolbox_tpu_torch import create_backbone
from vision_toolbox_tpu_torch.models.swin import SwinTransformer
from vision_toolbox_tpu_torch.nn.layers import DepthwiseConv
from vision_toolbox_tpu_torch.ops import (
    block_attention, block_mlp, cait_attention, flash_attention, short_attention, swin_attention,
    swin_relayout,
)
from vision_toolbox_tpu_torch.utils.profile import (
    count_params, device_memory_mb, flops, frozen, profile_model,
)

vtt = torch.ops.vtt
JAX_GAP_VIT_TI_64 = 11_096_112  # FLOPs, XLA's count minus the port's


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name,size", [("vit_ti_16", 64), ("cait_xxs_24", 64), ("swin_t", 224),
                                       ("convnext_t", 64), ("resnet50", 64),
                                       ("mobilenet_v3_large", 64)])
def test_count_params_matches_jax(name, size):
    kw = {"img_size": size} if name.startswith(("vit", "cait", "swin")) else {}
    jax_model = jax_create_backbone(name, **kw)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, size, size, 3)), train=False))
    with torch.device("meta"):
        model = create_backbone(name, device="meta", **kw)
    assert count_params(model) == jax_count_params(shapes["params"])


def _g(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed + sum(shape)))


def _op_cases():
    x, d, dh = _g(2, 5, 32), 32, 64
    ln = (torch.ones(d), torch.zeros(d))
    mlp = (x, *ln, _g(dh, d), _g(dh), _g(d, dh), _g(d), None, None, None, 1e-6)
    attn = (x, *ln, *[t for _ in range(4) for t in (_g(d, d), _g(d))], 2, None, None, 1e-6)
    q, k, v = _g(2, 5, 32), _g(2, 7, 32), _g(2, 7, 32)
    mixes = (_g(4, 4), _g(4), _g(4, 4), _g(4))
    pq, pk, pv = _g(2, 8, 2, 16), _g(2, 10, 2, 16), _g(2, 10, 2, 16)
    flat = lambda t: t.permute(0, 2, 1, 3).reshape(-1, t.shape[1], t.shape[3])
    wq, wk, wv, pe = _g(2, 4, 9, 16), _g(2, 4, 9, 16), _g(2, 4, 9, 16), _g(1, 2, 9, 9)
    img = _g(2, 8, 8, 4)
    dx, dw = _g(2, 6, 6, 8), _g(3, 3, 1, 8)
    return {
        "fused_mlp_block": (lambda: vtt.fused_mlp_block(*mlp),
                            lambda: block_mlp.fused_mlp_block_plain(*mlp)),
        "fused_attention_block": (lambda: vtt.fused_attention_block(*attn),
                                  lambda: block_attention.fused_attention_block_plain(*attn)),
        "talking_head_attention": (
            lambda: vtt.talking_head_attention(q, k, v, *mixes),
            lambda: cait_attention.talking_head_plain(q, k, v, *mixes)),
        "depthwise_conv2d": (
            lambda: vtt.depthwise_conv2d(dx, dw),
            lambda: F.conv2d(dx.permute(0, 3, 1, 2), dw.permute(3, 2, 0, 1), padding=1, groups=8)),
        "flash_attention": (lambda: vtt.flash_attention(pq, pk, pv, None),
                            lambda: flash_attention.flash_attention_plain(flat(pq), flat(pk),
                                                                          flat(pv))),
        "short_attention": (lambda: vtt.short_attention(pq, pk, pv),
                            lambda: short_attention.short_attention_plain(pq, pk, pv)),
        "swin_window_attention": (
            lambda: vtt.swin_window_attention(wq, wk, wv, pe, None, 2),
            lambda: swin_attention.swin_attention_plain(wq, wk, wv, pe, None, 2)),
        "swin_window_partition": (
            lambda: vtt.swin_window_partition(img, 4, 2),
            lambda: swin_relayout.shifted_window_partition_plain(img, 4, 2)),
        "swin_window_unpartition": (
            lambda: vtt.swin_window_unpartition(_g(2, 4, 16, 4), 4, 2, 8, 8),
            lambda: swin_relayout.shifted_window_unpartition_plain(_g(2, 4, 16, 4), 4, 2, 8, 8)),
    }


@pytest.mark.parametrize("op", list(_op_cases()))
def test_each_formula_counts_its_plain_version(op):
    kernel, plain = _op_cases()[op]
    with torch.no_grad():
        got, want = _count(kernel), _count(plain)
    assert got == want
    assert (got == 0) == op.endswith("partition")


def _depthwise_taps(model, run) -> int:
    """FLOPs of the grouped convolutions computing ``model``'s depthwise
    convs in ``run()``."""
    shapes = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: shapes.append(
        (inp[0].shape, mod.weight.shape[-1]))) for m in model.modules()
        if isinstance(m, DepthwiseConv)]
    run()
    for h in hooks:
        h.remove()
    return sum(_count(lambda: F.conv2d(torch.empty(B, C, H, W, device="meta"),
                                       torch.empty(C, 1, k, k, device="meta"),
                                       padding=k // 2, groups=C))
               for (B, H, W, C), k in shapes)


@pytest.mark.parametrize("name", ["vit_ti_16", "cait_xxs_24", "swin", "convnext_t"])
def test_kernel_path_counts_the_plain_path(name):
    if name == "swin":  # 64 px, windows of 4: both relayouts and K7 on every block
        model = SwinTransformer(64, 32, 2, (2, 2), (4, 4), device="cpu")
    else:
        model = create_backbone(name, device="cpu",
                                **({} if name == "convnext_t" else {"img_size": 64}))
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with frozen(model), torch.no_grad():
        kernel = flops(model, x)
        taps = _depthwise_taps(model, lambda: model(x, plain=True))
        plain = flops(lambda: model(x, plain=True))
    assert kernel > 0 and (taps > 0) == (name == "convnext_t")
    assert round(kernel * 1e9) == round(plain * 1e9) + taps


def test_gap_to_the_jax_count_at_vit_ti_16():
    jax_model = jax_create_backbone("vit_ti_16", img_size=64)
    variables = jax_model.init_variables(0, 64)
    want = jax_flops(lambda v, x: jax_model.apply(v, x), variables, jnp.zeros((1, 64, 64, 3)))
    model = create_backbone("vit_ti_16", img_size=64, device="cpu")
    with frozen(model), torch.no_grad():
        got = flops(model, torch.zeros(1, 64, 64, 3))
    assert round(got * 1e9) == 187_868_160
    assert round(want * 1e9) - round(got * 1e9) == JAX_GAP_VIT_TI_64


def test_profile_model_on_the_cpu():
    model = create_backbone("vit_ti_16", img_size=32, device="cpu")
    out = profile_model(model, (2, 32, 32, 3), n=2)
    assert set(out) == {"params_m", "gflops", "fwd_ms", "fwd_bwd_ms"}
    assert out["params_m"] == count_params(model) and out["gflops"] > 0
    assert out["fwd_ms"] > 0 and out["fwd_bwd_ms"] > 0
    assert all(p.grad is None and p.requires_grad for p in model.parameters())
    assert device_memory_mb() == {} and device_memory_mb("cpu") == {}
