"""Pretrained weight registry and loader — port of
``vision_toolbox_tpu/models/pretrained.py``.

The URL tables are the JAX package's, copied, and mirror the reference's
checkpoint sources:
  * its own GitHub release backbones (darknet.py:17,92-94; vovnet.py:121-134)
  * AugReg / SigLIP / Mixer .npz on GCS (vit.py:189-207, mlp_mixer.py:73-81)
  * official FB DeiT/CaiT (deit.py:59-65, cait.py:161-173),
    MS Swin (swin.py:193-200), FB ConvNeXt (convnext.py:131-150)
  * torchvision's IMAGENET1K_V1 files for the extractor backbones.

``load_pretrained(name, ...)`` returns the port's backbone with the
checkpoint's weights in place (the torchvision idiom; the JAX package returns
``(model, variables)``). A file is read from the download cache
(``utils/download.py``: ``VTT_CACHE_DIR``, shared with the JAX package) and
fetched only when it is not there. Each checkpoint goes through the JAX
package's converter (``utils/torch_interop.py``, ``utils/flax_ckpt.py``,
copies) to a JAX-layout tree and then through ``utils/jax_bridge.py`` to the
port's state dict, loaded with ``strict=True``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils import torch_interop as ti
from ..utils.download import cached_download
from ..utils.flax_ckpt import load_mixer_npz, load_vit_npz
from ..utils.jax_bridge import flax_to_state_dict
from ..utils.torch_pth import load_pth
from .base import Backbone, create_backbone, to_device
from .darknet import CSPDarknetStage

_REF_RELEASE = "https://github.com/gau-nernst/vision-toolbox/releases/download/v0.0.1/"
_DEIT_URL = "https://dl.fbaipublicfiles.com/deit/"
_CONVNEXT_URL = "https://dl.fbaipublicfiles.com/convnext/"
_SWIN_URL = "https://github.com/SwinTransformer/storage/releases/download/"

# reference-trained conv backbones (reference release assets)
BACKBONE_CKPTS = {
    "darknet19": "darknet19-2cb641ca.pth",
    "darknet53": "darknet53-94427f5b.pth",
    "cspdarknet53": "cspdarknet53-3bfa0423.pth",
    "darknet_yolov5n": "darknet_yolov5n-68f182f1.pth",
    "darknet_yolov5s": "darknet_yolov5s-175f7462.pth",
    "darknet_yolov5m": "darknet_yolov5m-9866aa40.pth",
    "darknet_yolov5l": "darknet_yolov5l-8e25d388.pth",
    "darknet_yolov5x": "darknet_yolov5x-0ed0c035.pth",
    "vovnet27_slim": "vovnet27_slim-dd43306a.pth",
    "vovnet39": "vovnet39-4c79d629.pth",
    "vovnet57": "vovnet57-ecb9cc34.pth",
    "vovnet19_slim_ese": "vovnet19_slim_ese-f8075640.pth",
    "vovnet19_ese": "vovnet19_ese-a077657e.pth",
    "vovnet39_ese": "vovnet39_ese-9ce81b0d.pth",
    "vovnet57_ese": "vovnet57_ese-ae1a7f89.pth",
    "vovnet99_ese": "vovnet99_ese-713f3062.pth",
}

# AugReg ViT (vit.py:189-196); all 224px
AUGREG_CKPTS = {
    "vit_ti_16": "Ti_16-i21k-300ep-lr_0.001-aug_none-wd_0.03-do_0.0-sd_0.0.npz",
    "vit_s_32": "S_32-i21k-300ep-lr_0.001-aug_none-wd_0.1-do_0.0-sd_0.0.npz",
    "vit_s_16": "S_16-i21k-300ep-lr_0.001-aug_light1-wd_0.03-do_0.0-sd_0.0.npz",
    "vit_b_32": "B_32-i21k-300ep-lr_0.001-aug_light1-wd_0.1-do_0.0-sd_0.0.npz",
    "vit_b_16": "B_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.0-sd_0.0.npz",
    "vit_l_16": "L_16-i21k-300ep-lr_0.001-aug_strong1-wd_0.1-do_0.0-sd_0.0.npz",
}

# SigLIP (vit.py:200-207): (name, img_size) -> file
SIGLIP_CKPTS = {
    ("vit_b_16", 224): "webli_en_b16_224_63724782.npz",
    ("vit_b_16", 256): "webli_en_b16_256_60500360.npz",
    ("vit_b_16", 384): "webli_en_b16_384_68578854.npz",
    ("vit_b_16", 512): "webli_en_b16_512_68580893.npz",
    ("vit_l_16", 256): "webli_en_l16_256_60552751.npz",
    ("vit_l_16", 384): "webli_en_l16_384_63634585.npz",
}

# Mixer (mlp_mixer.py:73-80)
MIXER_CKPTS = {
    "mixer_s_8": "gsam/Mixer-S_8.npz",
    "mixer_s_16": "gsam/Mixer-S_16.npz",
    "mixer_s_32": "gsam/Mixer-S_32.npz",
    "mixer_b_16": "imagenet21k/Mixer-B_16.npz",
    "mixer_b_32": "gsam/Mixer-B_32.npz",
    "mixer_l_16": "imagenet21k/Mixer-L_16.npz",
}

# official FB DeiT, distilled (deit.py:59-65): (name, img_size) -> file
DEIT_CKPTS = {
    ("deit_ti_16", 224): "deit_tiny_distilled_patch16_224-b40b3cf7.pth",
    ("deit_s_16", 224): "deit_small_distilled_patch16_224-649709d9.pth",
    ("deit_b_16", 224): "deit_base_distilled_patch16_224-df68dfff.pth",
    ("deit_b_16", 384): "deit_base_distilled_patch16_384-d0272ac0.pth",
}

# official FB DeiT3, in21k (deit.py:156-165); huge is patch 14 upstream
DEIT3_CKPTS = {
    ("deit3_s_16", 224): "deit_3_small_224_21k.pth",
    ("deit3_s_16", 384): "deit_3_small_384_21k.pth",
    ("deit3_b_16", 224): "deit_3_base_224_21k.pth",
    ("deit3_b_16", 384): "deit_3_base_384_21k.pth",
    ("deit3_l_16", 224): "deit_3_large_224_21k.pth",
    ("deit3_l_16", 384): "deit_3_large_384_21k.pth",
    ("deit3_h_14", 224): "deit_3_huge_224_21k.pth",
}

# official FB CaiT (cait.py:161-173)
CAIT_CKPTS = {
    ("cait_xxs_24", 224): "XXS24_224.pth",
    ("cait_xxs_24", 384): "XXS24_384.pth",
    ("cait_xxs_36", 224): "XXS36_224.pth",
    ("cait_xxs_36", 384): "XXS36_384.pth",
    ("cait_xs_24", 384): "XS24_384.pth",
    ("cait_s_24", 224): "S24_224.pth",
    ("cait_s_24", 384): "S24_384.pth",
    ("cait_s_36", 384): "S36_384.pth",
    ("cait_m_36", 384): "M36_384.pth",
    ("cait_m_48", 448): "M48_448.pth",
}

# official MS Swin 22k + AutoFormerV2 S3 supernets (swin.py:193-207)
SWIN_CKPTS = {
    "swin_t": "v1.0.8/swin_tiny_patch4_window7_224_22k.pth",
    "swin_s": "v1.0.8/swin_small_patch4_window7_224_22k.pth",
    "swin_b": "v1.0.0/swin_base_patch4_window7_224_22k.pth",
    "swin_l": "v1.0.0/swin_large_patch4_window7_224_22k.pth",
    "swin_s3-t": "supernet-tiny.pth",
    "swin_s3-s": "supernet-small.pth",
    "swin_s3-b": "supernet-base.pth",
}
_S3_URL = "https://github.com/silent-chen/AutoFormer-model-zoo/releases/download/v1.0/"

# torchvision IMAGENET1K_V1 checkpoints (the reference's extractor backbones
# load these via pretrained=True, torchvision_models.py:23-55); the URL
# hashes are recorded from the torchvision registry. A checkpoint dropped
# into the cache dir (VTT_CACHE_DIR) by filename is used without any
# download.
_TORCHVISION_URL = "https://download.pytorch.org/models/"
TORCHVISION_CKPTS = {
    "resnet18": "resnet18-f37072fd.pth",
    "resnet34": "resnet34-b627a593.pth",
    "resnet50": "resnet50-0676ba61.pth",
    "resnet101": "resnet101-63fe2227.pth",
    "resnet152": "resnet152-394f9c45.pth",
    "resnext50_32x4d": "resnext50_32x4d-7cdf4587.pth",
    "resnext101_32x8d": "resnext101_32x8d-8ba56ff5.pth",
    "wide_resnet50_2": "wide_resnet50_2-95faca4d.pth",
    "wide_resnet101_2": "wide_resnet101_2-32ee1156.pth",
    "mobilenet_v3_large": "mobilenet_v3_large-8738ca79.pth",
    "mobilenet_v3_small": "mobilenet_v3_small-047dcff4.pth",
    "efficientnet_b0": "efficientnet_b0_rwightman-3dd342df.pth",
    "efficientnet_b1": "efficientnet_b1_rwightman-533bc792.pth",
    "efficientnet_b2": "efficientnet_b2_rwightman-bcdf34b7.pth",
    "efficientnet_b3": "efficientnet_b3_rwightman-cf984f9c.pth",
    "efficientnet_b4": "efficientnet_b4_rwightman-7eb33cd5.pth",
    "efficientnet_b5": "efficientnet_b5_lukemelas-b6417697.pth",
    "efficientnet_b6": "efficientnet_b6_lukemelas-c76e70fd.pth",
    "efficientnet_b7": "efficientnet_b7_lukemelas-dcc49843.pth",
    "regnet_x_400mf": "regnet_x_400mf-adf1edd5.pth",
    "regnet_x_800mf": "regnet_x_800mf-ad17e45c.pth",
    "regnet_x_1_6gf": "regnet_x_1_6gf-e3633e7f.pth",
    "regnet_x_3_2gf": "regnet_x_3_2gf-f342aeae.pth",
    "regnet_x_8gf": "regnet_x_8gf-03ceed89.pth",
    "regnet_x_16gf": "regnet_x_16gf-2007eb11.pth",
    "regnet_x_32gf": "regnet_x_32gf-9d47f8d0.pth",
    "regnet_y_400mf": "regnet_y_400mf-c65dace8.pth",
    "regnet_y_800mf": "regnet_y_800mf-1b27b58c.pth",
    "regnet_y_1_6gf": "regnet_y_1_6gf-b11a554e.pth",
    "regnet_y_3_2gf": "regnet_y_3_2gf-b5a9779c.pth",
    "regnet_y_8gf": "regnet_y_8gf-d0d0e4a8.pth",
    "regnet_y_16gf": "regnet_y_16gf-9e6ed7dd.pth",
    "regnet_y_32gf": "regnet_y_32gf-4dee3f7a.pth",
}

# official FB ConvNeXt v1 22k / v2 FCMAE (convnext.py:131-150)
CONVNEXT_CKPTS = {
    "convnext_t": "convnext_tiny_22k_224.pth",
    "convnext_s": "convnext_small_22k_224.pth",
    "convnext_b": "convnext_base_22k_224.pth",
    "convnext_l": "convnext_large_22k_224.pth",
    "convnext_xl": "convnext_xlarge_22k_224.pth",
    "convnextv2_a": "convnextv2_atto_1k_224_fcmae.pt",
    "convnextv2_f": "convnextv2_femto_1k_224_fcmae.pt",
    "convnextv2_p": "convnextv2_pico_1k_224_fcmae.pt",
    "convnextv2_n": "convnextv2_nano_1k_224_fcmae.pt",
    "convnextv2_t": "convnextv2_tiny_1k_224_fcmae.pt",
    "convnextv2_b": "convnextv2_base_1k_224_fcmae.pt",
    "convnextv2_l": "convnextv2_large_1k_224_fcmae.pt",
    "convnextv2_h": "convnextv2_huge_1k_224_fcmae.pt",
}


def _build(name: str, **kwargs: Any) -> Backbone:
    """``name`` built on the meta device, its initial weights not drawn; a
    model holding tensors that its state dict does not carry (Swin's
    relative-position index and shift mask) is built on the CPU instead."""
    with torch.device("meta"):
        model = create_backbone(name, device="meta", **kwargs)
    held = {n for n, _ in model.named_parameters()} | {n for n, _ in model.named_buffers()}
    if held != set(model.state_dict()):
        model = create_backbone(name, device="cpu", **kwargs)
    return model


def _official_sd(url: str) -> dict:
    sd = load_pth(cached_download(url))
    return sd["model"] if isinstance(sd, dict) and "model" in sd else sd


def _tree(name: str, model: Backbone, img_size: int, weights: str | None) -> dict:
    """The checkpoint of ``name`` as a JAX-layout {"params", "batch_stats"}
    tree for ``model``, by the JAX function's rules."""
    if name in BACKBONE_CKPTS and not weights:
        sd = load_pth(cached_download(_REF_RELEASE + BACKBONE_CKPTS[name]))
        if name.startswith("darknet_yolov5"):
            return ti.convert_darknet(sd, model.stage_configs, csp=True, yolov5=True)
        if name.startswith(("darknet", "cspdarknet")):
            csp = any(isinstance(m, CSPDarknetStage) for m in model.modules())
            return ti.convert_darknet(sd, model.stage_configs, csp=csp)
        return ti.convert_vovnet(sd, model.stage_configs, ese=model.stages[0][0].ese is not None)

    if name.startswith("vit_"):
        if weights == "siglip":
            path = cached_download(
                f"https://storage.googleapis.com/big_vision/siglip/{SIGLIP_CKPTS[(name, img_size)]}"
            )
            params = load_vit_npz(path, len(model.blocks), big_vision=True, prefix="params/img/")
        else:  # augreg
            path = cached_download(
                f"https://storage.googleapis.com/vit_models/augreg/{AUGREG_CKPTS[name]}"
            )
            params = load_vit_npz(path, len(model.blocks))
        return {"params": params}

    if name.startswith("mixer_"):
        path = cached_download(f"https://storage.googleapis.com/mixer_models/{MIXER_CKPTS[name]}")
        return {"params": load_mixer_npz(path, len(model.blocks))}

    if name.startswith("deit"):
        table = DEIT3_CKPTS if name.startswith("deit3") else DEIT_CKPTS
        sd = _official_sd(_DEIT_URL + table[(name, img_size)])
        distilled = not name.startswith("deit3")
        return ti.convert_deit(sd, len(model.blocks), distilled=distilled,
                               layer_scale=not distilled)

    if name.startswith("cait_"):
        sd = _official_sd(_DEIT_URL + CAIT_CKPTS[(name, img_size)])
        return ti.convert_cait(sd, len(model.sa_blocks), len(model.ca_blocks))

    if name.startswith("swin_"):
        # relative PE and masks are built for any compatible resolution, so
        # the 224 px checkpoint loads directly at img_size
        base = _S3_URL if "s3" in name else _SWIN_URL
        return ti.convert_swin(_official_sd(base + SWIN_CKPTS[name]), model.depths)

    if name in TORCHVISION_CKPTS:
        sd = _official_sd(_TORCHVISION_URL + TORCHVISION_CKPTS[name])
        if name.startswith(("resnet", "resnext", "wide_resnet")):
            return ti.convert_resnet(sd, model.depths, model.bottleneck)
        if name.startswith("mobilenet_v3"):
            return ti.convert_mobilenet_v3(sd, model.config)
        if name.startswith("efficientnet"):
            return ti.convert_efficientnet(sd, model._stages())
        return ti.convert_regnet(sd, model.stage_config, se=model.stages[0][0].se is not None)

    if name.startswith("convnext"):
        v2 = model.stages[0][0].grn is not None
        base = _CONVNEXT_URL + ("convnextv2/pt_only/" if v2 else "")
        tree = ti.convert_convnext(_official_sd(base + CONVNEXT_CKPTS[name]), model.depths,
                                   v2=v2)
        if "norm" not in tree["params"]:
            # FCMAE checkpoints lack the head norm (convnext.py:186-191);
            # keep it at the LayerNorm default init, as the reference does
            dd = model.d_model * 2 ** (len(model.depths) - 1)
            tree["params"]["norm"] = {"scale": np.ones(dd, np.float32),
                                      "bias": np.zeros(dd, np.float32)}
        return tree

    raise KeyError(f"no pretrained weights registered for {name!r}")


def load_pretrained(name: str, img_size: int = 224, weights: str | None = None, *,
                    dtype: torch.dtype | None = None, device: torch.device | str | None = None,
                    **kwargs: Any) -> Backbone:
    """Build ``name`` (``dtype``: its compute type; ``device``: the card
    unless the caller asks for another, as every model) with the JAX
    function's arguments and load its pretrained weights (``strict``).
    ``weights="siglip"`` takes a ViT's SigLIP checkpoint at ``img_size``
    (MAP pooling, no cls token); AugReg ViTs are 224 px (``ValueError``
    otherwise). Raises ``KeyError`` for a name (or size) without a registered
    checkpoint."""
    if name.startswith("vit_") and weights == "siglip":
        kwargs = dict(cls_token=False, pool_type="mha") | kwargs
    elif name.startswith("vit_") and img_size != 224:
        raise ValueError(f"AugReg checkpoints are 224px (vit.py:188), not {img_size}")
    if name.startswith(("vit_", "mixer_", "deit", "cait_", "swin_")):
        kwargs["img_size"] = img_size
    model = _build(name, dtype=dtype, **kwargs)
    tree = _tree(name, model, img_size, weights)
    model.load_state_dict(flax_to_state_dict(tree["params"], tree.get("batch_stats")),
                          strict=True, assign=True)
    to_device(model, "cuda" if device is None else device)
    return model
