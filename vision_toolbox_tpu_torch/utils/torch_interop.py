"""Official state dict → JAX-layout parameter tree — a copy of
``vision_toolbox_tpu/utils/torch_interop.py`` (numpy only), kept in the port
so that the port imports nothing of the JAX package.

Two source layouts are supported, mirroring the reference's checkpoint story
(SURVEY.md §5.4):
  * the reference's own released backbone ``.pth`` files (Darknet/VoVNet/
    YOLOv5; module layout of vision_toolbox — darknet.py/vovnet.py), produced
    by its extract_backbone_weights (extras.py:112-128);
  * official upstream releases the reference remaps on load: FB DeiT
    (deit.py:71-115), FB CaiT (cait.py:180-230), MS Swin (swin.py:216-263),
    FB ConvNeXt v1/v2 (convnext.py:156-191), and torchvision's.

All converters take a flat ``{name: np.ndarray}`` dict (from
``utils/torch_pth.load_pth`` or any other source) and the model's config,
and return ``{"params": ..., "batch_stats": ...}`` trees in the JAX
package's layout; ``models/pretrained.py`` turns them into the port's state
dict with ``utils/jax_bridge.flax_to_state_dict``, the one layout rule of
the port.

Weight layout rules: conv OIHW→HWIO, depthwise (C,1,k,k)→(k,k,1,C),
linear (out,in)→(in,out), qkv chunked along dim 0 (deit.py:96-103).
"""

from __future__ import annotations

import numpy as np


def conv_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def dwconv_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # (C,1,k,k)->(k,k,1,C)


def linear_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


class _SD:
    """State-dict wrapper that tracks consumption."""

    def __init__(self, sd: dict[str, np.ndarray]):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}

    def pop(self, key: str) -> np.ndarray:
        return self.sd.pop(key)

    def has(self, key: str) -> bool:
        return key in self.sd

    def remaining(self, ignore_prefixes: tuple[str, ...] = ()) -> list[str]:
        return [
            k
            for k in self.sd
            if not any(k.startswith(p) for p in ignore_prefixes)
            and not k.endswith("num_batches_tracked")
        ]


def _cna(sd: _SD, prefix: str) -> tuple[dict, dict]:
    """ConvNormAct: {conv,norm} params + running stats."""
    params: dict = {"conv": {"kernel": conv_w(sd.pop(f"{prefix}.conv.weight"))}}
    if sd.has(f"{prefix}.conv.bias"):
        params["conv"]["bias"] = sd.pop(f"{prefix}.conv.bias")
    stats: dict = {}
    if sd.has(f"{prefix}.norm.weight"):
        params["norm"] = {
            "scale": sd.pop(f"{prefix}.norm.weight"),
            "bias": sd.pop(f"{prefix}.norm.bias"),
        }
        stats["norm"] = {
            "mean": sd.pop(f"{prefix}.norm.running_mean"),
            "var": sd.pop(f"{prefix}.norm.running_var"),
        }
    return params, stats


def _ln(sd: _SD, prefix: str) -> dict:
    return {"scale": sd.pop(f"{prefix}.weight"), "bias": sd.pop(f"{prefix}.bias")}


def _linear(sd: _SD, prefix: str) -> dict:
    out = {"kernel": linear_w(sd.pop(f"{prefix}.weight"))}
    if sd.has(f"{prefix}.bias"):
        out["bias"] = sd.pop(f"{prefix}.bias")
    return out


def _check_done(sd: _SD, ignore: tuple[str, ...] = ("head",)) -> None:
    left = sd.remaining(ignore)
    if left:
        raise ValueError(f"unconsumed checkpoint entries: {left[:8]}{'...' if len(left) > 8 else ''}")


# ---------------------------------------------------------------------------
# Reference-release conv backbones
# ---------------------------------------------------------------------------

def convert_darknet(sd_raw: dict, stage_configs, csp: bool, yolov5: bool = False) -> dict:
    """Reference Darknet/CSPDarknet/YOLOv5 layout (darknet.py:63-137) → ours."""
    sd = _SD(sd_raw)
    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = _cna(sd, "stem")
    for i, (n_blocks, _out_ch) in enumerate(stage_configs):
        ours = f"stage_{i}"
        ref = f"stages.{i}"
        p: dict = {}
        s: dict = {}
        if n_blocks == 0 and not yolov5:
            # bare ConvNormAct stage (darknet.py:79)
            params[ours], stats[ours] = _cna(sd, ref)
            continue
        p["conv"], s["conv"] = _cna(sd, f"{ref}.conv")
        if csp or yolov5:
            for name in ("conv1", "conv2", "out_conv"):
                p[name], s[name] = _cna(sd, f"{ref}.{name}")
        for j in range(n_blocks):
            block: dict = {}
            bstat: dict = {}
            for name in ("conv1", "conv2"):
                block[name], bstat[name] = _cna(sd, f"{ref}.blocks.{j}.{name}")
            p[f"block_{j}"] = block
            s[f"block_{j}"] = bstat
        params[ours] = p
        stats[ours] = s
    _check_done(sd)
    return {"params": params, "batch_stats": stats}


def convert_vovnet(sd_raw: dict, stage_configs, ese: bool) -> dict:
    """Reference VoVNet layout (vovnet.py:73-104) → ours."""
    sd = _SD(sd_raw)
    params: dict = {}
    stats: dict = {}
    for i in range(3):
        params[f"stem_{i}"], stats[f"stem_{i}"] = _cna(sd, f"stem.{i}")
    for i, (n_blocks, _mid, n_layers, _out) in enumerate(stage_configs):
        for j in range(n_blocks):
            ours = f"stage_{i}_block_{j}"
            ref = f"stages.{i}.module_{j}"
            p: dict = {}
            s: dict = {}
            for k in range(n_layers):
                p[f"conv_{k}"], s[f"conv_{k}"] = _cna(sd, f"{ref}.convs.{k}")
            p["out_conv"], s["out_conv"] = _cna(sd, f"{ref}.out_conv")
            if ese:
                w = sd.pop(f"{ref}.ese.linear.weight")  # (C, C, 1, 1)
                p["ese"] = {
                    "linear": {
                        "kernel": conv_w(w),
                        "bias": sd.pop(f"{ref}.ese.linear.bias"),
                    }
                }
            params[ours] = p
            stats[ours] = s
    _check_done(sd)
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# Official upstream transformer checkpoints
# ---------------------------------------------------------------------------

def _qkv_chunk(sd: _SD, prefix: str) -> dict:
    """Official packed qkv → separate projections (deit.py:96-103)."""
    qw, kw, vw = np.split(sd.pop(f"{prefix}.qkv.weight"), 3, axis=0)
    out = {
        "q_proj": {"kernel": linear_w(qw)},
        "k_proj": {"kernel": linear_w(kw)},
        "v_proj": {"kernel": linear_w(vw)},
    }
    if sd.has(f"{prefix}.qkv.bias"):
        qb, kb, vb = np.split(sd.pop(f"{prefix}.qkv.bias"), 3, axis=0)
        out["q_proj"]["bias"] = qb
        out["k_proj"]["bias"] = kb
        out["v_proj"]["bias"] = vb
    out["out_proj"] = _linear(sd, f"{prefix}.proj")
    return out


def _vit_block_official(sd: _SD, prefix: str, layer_scale: bool) -> dict:
    block = {
        "mha_norm": _ln(sd, f"{prefix}.norm1"),
        "mha": _qkv_chunk(sd, f"{prefix}.attn"),
        "mlp_norm": _ln(sd, f"{prefix}.norm2"),
        "mlp": {
            "linear1": _linear(sd, f"{prefix}.mlp.fc1"),
            "linear2": _linear(sd, f"{prefix}.mlp.fc2"),
        },
    }
    if layer_scale:
        block["mha_scale"] = {"gamma": sd.pop(f"{prefix}.gamma_1")}
        block["mlp_scale"] = {"gamma": sd.pop(f"{prefix}.gamma_2")}
    return block


def convert_deit(sd_raw: dict, depth: int, distilled: bool = True, layer_scale: bool = False) -> dict:
    """Official FB DeiT/DeiT3 .pth layout → ours (deit.py:71-115).

    The official PE covers (cls[, dist], patches); the reference folds the
    token PEs into the tokens themselves (deit.py:79-87)."""
    sd = _SD(sd_raw)
    params: dict = {"patch_embed": {
        "kernel": conv_w(sd.pop("patch_embed.proj.weight")),
        "bias": sd.pop("patch_embed.proj.bias"),
    }}
    pe = sd.pop("pos_embed")
    cls_token = sd.pop("cls_token")
    # official PE may cover [cls(, dist), patches] or patches only; our pe
    # holds patch rows and any token PEs fold into the tokens (deit.py:78-87).
    # the patch count is the largest perfect square ≤ total rows.
    total = pe.shape[1]
    n_patch = total
    for extra in (0, 1, 2):
        side = int(round((total - extra) ** 0.5))
        if side * side == total - extra:
            n_patch = total - extra
            break
    params["pe"] = pe[:, -n_patch:]
    extra = total - n_patch
    if extra > 0:
        cls_token = cls_token + pe[:, 0]
    params["cls_token"] = cls_token
    if distilled:
        dist_token = sd.pop("dist_token")
        if extra > 1:
            dist_token = dist_token + pe[:, 1]
        params["dist_token"] = dist_token
        for k in ("head_dist.weight", "head_dist.bias"):
            if sd.has(k):
                sd.pop(k)
    for i in range(depth):
        params[f"block_{i}"] = _vit_block_official(sd, f"blocks.{i}", layer_scale)
    params["norm"] = _ln(sd, "norm")
    _check_done(sd)
    return {"params": params}


def convert_cait(sd_raw: dict, sa_depth: int, ca_depth: int = 2) -> dict:
    """Official FB CaiT layout → ours (cait.py:180-230)."""
    sd = _SD({k.replace("module.", ""): v for k, v in sd_raw.items()})
    params: dict = {
        "patch_embed": {
            "kernel": conv_w(sd.pop("patch_embed.proj.weight")),
            "bias": sd.pop("patch_embed.proj.bias"),
        },
        "cls_token": sd.pop("cls_token"),
        "pe": sd.pop("pos_embed"),
        "norm": _ln(sd, "norm"),
    }
    for i in range(sa_depth):
        p = f"blocks.{i}"
        mha = _qkv_chunk(sd, f"{p}.attn")
        wl = sd.pop(f"{p}.attn.proj_l.weight")  # (H, H, 1, 1) conv1x1 over heads
        mha["proj_l_kernel"] = wl.reshape(wl.shape[0], wl.shape[1])
        mha["proj_l_bias"] = sd.pop(f"{p}.attn.proj_l.bias")
        ww = sd.pop(f"{p}.attn.proj_w.weight")
        mha["proj_w_kernel"] = ww.reshape(ww.shape[0], ww.shape[1])
        mha["proj_w_bias"] = sd.pop(f"{p}.attn.proj_w.bias")
        params[f"sa_block_{i}"] = {
            "mha_norm": _ln(sd, f"{p}.norm1"),
            "mha": mha,
            "mha_scale": {"gamma": sd.pop(f"{p}.gamma_1")},
            "mlp_norm": _ln(sd, f"{p}.norm2"),
            "mlp": {
                "linear1": _linear(sd, f"{p}.mlp.fc1"),
                "linear2": _linear(sd, f"{p}.mlp.fc2"),
            },
            "mlp_scale": {"gamma": sd.pop(f"{p}.gamma_2")},
        }
    for i in range(ca_depth):
        p = f"blocks_token_only.{i}"
        params[f"ca_block_{i}"] = {
            "mha_norm": _ln(sd, f"{p}.norm1"),
            "mha": {
                "q_proj": _linear(sd, f"{p}.attn.q"),
                "k_proj": _linear(sd, f"{p}.attn.k"),
                "v_proj": _linear(sd, f"{p}.attn.v"),
                "out_proj": _linear(sd, f"{p}.attn.proj"),
            },
            "mha_scale": {"gamma": sd.pop(f"{p}.gamma_1")},
            "mlp_norm": _ln(sd, f"{p}.norm2"),
            "mlp": {
                "linear1": _linear(sd, f"{p}.mlp.fc1"),
                "linear2": _linear(sd, f"{p}.mlp.fc2"),
            },
            "mlp_scale": {"gamma": sd.pop(f"{p}.gamma_2")},
        }
    _check_done(sd)
    return {"params": params}


def _swin_rearrange(p: np.ndarray) -> np.ndarray:
    """Official patch-merge weight order (p1,p2,p3,p4) → ours (p1,p3,p2,p4)
    (swin.py:229-235)."""
    p1, p2, p3, p4 = np.split(p, 4, axis=-1)
    return np.concatenate([p1, p3, p2, p4], axis=-1)


def convert_swin(sd_raw: dict, depths) -> dict:
    """Official MS Swin layout → ours (swin.py:216-263)."""
    sd = _SD(sd_raw)
    params: dict = {
        "patch_embed": {
            "kernel": conv_w(sd.pop("patch_embed.proj.weight")),
            "bias": sd.pop("patch_embed.proj.bias"),
        },
        "patch_norm": _ln(sd, "patch_embed.norm"),
        "norm": _ln(sd, "norm"),
    }
    for s, depth in enumerate(depths):
        if s > 0:
            p = f"layers.{s-1}.downsample"
            params[f"downsample_{s}"] = {
                "norm": {
                    "scale": _swin_rearrange(sd.pop(f"{p}.norm.weight")),
                    "bias": _swin_rearrange(sd.pop(f"{p}.norm.bias")),
                },
                "reduction": {
                    "kernel": linear_w(_swin_rearrange(sd.pop(f"{p}.reduction.weight")))
                },
            }
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}"
            mha = _qkv_chunk(sd, f"{p}.attn")
            mha["relative_pe_table"] = linear_w(
                sd.pop(f"{p}.attn.relative_position_bias_table")
            )[None]  # ((2w-1)², H) -> (1, H, (2w-1)²)
            sd.sd.pop(f"{p}.attn.relative_position_index", None)
            sd.sd.pop(f"{p}.attn_mask", None)
            params[f"stage_{s}_block_{b}"] = {
                "mha_norm": _ln(sd, f"{p}.norm1"),
                "mha": mha,
                "mlp_norm": _ln(sd, f"{p}.norm2"),
                "mlp": {
                    "linear1": _linear(sd, f"{p}.mlp.fc1"),
                    "linear2": _linear(sd, f"{p}.mlp.fc2"),
                },
            }
    _check_done(sd)
    return {"params": params}


def convert_convnext(sd_raw: dict, depths, v2: bool = False) -> dict:
    """Official FB ConvNeXt v1/v2 layout → ours (convnext.py:156-191)."""
    sd = _SD(sd_raw)
    params: dict = {
        "stem_conv": {
            "kernel": conv_w(sd.pop("downsample_layers.0.0.weight")),
            "bias": sd.pop("downsample_layers.0.0.bias"),
        },
        "stem_norm": _ln(sd, "downsample_layers.0.1"),
    }
    for s, depth in enumerate(depths):
        if s > 0:
            params[f"downsample_norm_{s}"] = _ln(sd, f"downsample_layers.{s}.0")
            params[f"downsample_conv_{s}"] = {
                "kernel": conv_w(sd.pop(f"downsample_layers.{s}.1.weight")),
                "bias": sd.pop(f"downsample_layers.{s}.1.bias"),
            }
        for b in range(depth):
            p = f"stages.{s}.{b}"
            block = {
                "dwconv": {
                    "kernel": dwconv_w(sd.pop(f"{p}.dwconv.weight")),
                    "bias": sd.pop(f"{p}.dwconv.bias"),
                },
                "norm": _ln(sd, f"{p}.norm"),
                "pwconv1": _linear(sd, f"{p}.pwconv1"),
                "pwconv2": _linear(sd, f"{p}.pwconv2"),
            }
            if v2:
                block["grn"] = {
                    "gamma": sd.pop(f"{p}.grn.gamma").reshape(-1),
                    "beta": sd.pop(f"{p}.grn.beta").reshape(-1),
                }
            elif sd.has(f"{p}.gamma"):
                block["layer_scale"] = {"gamma": sd.pop(f"{p}.gamma")}
            params[f"stage_{s}_block_{b}"] = block
    # FCMAE checkpoints lack the head norm (convnext.py:186-191)
    if sd.has("norm.weight"):
        params["norm"] = _ln(sd, "norm")
    _check_done(sd)
    return {"params": params}


# ---------------------------------------------------------------------------
# torchvision checkpoints (the reference's extractor backbones load these
# implicitly via pretrained=True, torchvision_models.py:23-55)
# ---------------------------------------------------------------------------


def _tv_cna(sd: _SD, conv: str, bn: str) -> tuple[dict, dict]:
    """torchvision Conv2d + BatchNorm2d pair → our ConvNormAct trees."""
    params: dict = {"conv": {"kernel": conv_w(sd.pop(f"{conv}.weight"))}}
    if sd.has(f"{conv}.bias"):
        params["conv"]["bias"] = sd.pop(f"{conv}.bias")
    params["norm"] = {"scale": sd.pop(f"{bn}.weight"), "bias": sd.pop(f"{bn}.bias")}
    stats = {
        "norm": {
            "mean": sd.pop(f"{bn}.running_mean"),
            "var": sd.pop(f"{bn}.running_var"),
        }
    }
    return params, stats


def _tv_se(sd: _SD, prefix: str) -> dict:
    """torchvision SqueezeExcitation (fc1/fc2 are 1×1 Conv2d) → our SE."""
    return {
        "fc1": {"kernel": conv_w(sd.pop(f"{prefix}.fc1.weight")), "bias": sd.pop(f"{prefix}.fc1.bias")},
        "fc2": {"kernel": conv_w(sd.pop(f"{prefix}.fc2.weight")), "bias": sd.pop(f"{prefix}.fc2.bias")},
    }


def convert_resnet(sd_raw: dict, depths, bottleneck: bool) -> dict:
    """torchvision ResNet/ResNeXt/WideResNet → ours (models/resnet.py)."""
    sd = _SD(sd_raw)
    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = _tv_cna(sd, "conv1", "bn1")
    n_convs = 3 if bottleneck else 2
    for i, depth in enumerate(depths):
        for j in range(depth):
            name = f"layer{i+1}_block{j}"
            p = f"layer{i+1}.{j}"
            bp: dict = {}
            bs: dict = {}
            for k in range(1, n_convs + 1):
                bp[f"conv{k}"], bs[f"conv{k}"] = _tv_cna(sd, f"{p}.conv{k}", f"{p}.bn{k}")
            if sd.has(f"{p}.downsample.0.weight"):
                bp["downsample"], bs["downsample"] = _tv_cna(
                    sd, f"{p}.downsample.0", f"{p}.downsample.1"
                )
            params[name] = bp
            stats[name] = bs
    _check_done(sd, ignore=("fc",))
    return {"params": params, "batch_stats": stats}


def _tv_mbconv(sd: _SD, p: str, has_expand: bool, has_se: bool) -> tuple[dict, dict]:
    """torchvision MBConv (features.{i}.block list of Conv2dNormActivation /
    SqueezeExcitation modules) → our MBConv (expand/dwconv/se/project)."""
    bp: dict = {}
    bs: dict = {}
    k = 0
    if has_expand:
        bp["expand"], bs["expand"] = _tv_cna(sd, f"{p}.block.{k}.0", f"{p}.block.{k}.1")
        k += 1
    bp["dwconv"], bs["dwconv"] = _tv_cna(sd, f"{p}.block.{k}.0", f"{p}.block.{k}.1")
    # depthwise torch kernel is (C, 1, kh, kw); conv_w gives (kh, kw, 1, C) ✓
    k += 1
    if has_se:
        bp["se"] = _tv_se(sd, f"{p}.block.{k}")
        k += 1
    bp["project"], bs["project"] = _tv_cna(sd, f"{p}.block.{k}.0", f"{p}.block.{k}.1")
    return bp, bs


def convert_mobilenet_v3(sd_raw: dict, config) -> dict:
    """torchvision MobileNetV3 → ours (models/mobilenet.py). ``config`` is the
    model's (kernel, expanded, out, use_se, act, stride) table."""
    sd = _SD(sd_raw)
    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = _tv_cna(sd, "features.0.0", "features.0.1")
    in_ch = 16
    for i, (_k, exp, out, use_se, _act, _s) in enumerate(config):
        bp, bs = _tv_mbconv(sd, f"features.{i+1}", has_expand=exp != in_ch, has_se=use_se)
        params[f"block_{i}"] = bp
        stats[f"block_{i}"] = bs
        in_ch = out
    n = len(config) + 1
    params["last_conv"], stats["last_conv"] = _tv_cna(sd, f"features.{n}.0", f"features.{n}.1")
    _check_done(sd, ignore=("classifier",))
    return {"params": params, "batch_stats": stats}


def convert_efficientnet(sd_raw: dict, stages) -> dict:
    """torchvision EfficientNet → ours (models/efficientnet.py). ``stages`` is
    the scaled (expand_ratio, kernel, stride, out_channels, num_layers) table."""
    sd = _SD(sd_raw)
    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = _tv_cna(sd, "features.0.0", "features.0.1")
    for si, (expand, _k, _s, _ch, n) in enumerate(stages):
        for j in range(n):
            bp, bs = _tv_mbconv(
                sd, f"features.{si+1}.{j}", has_expand=expand != 1, has_se=True
            )
            params[f"stage_{si}_block_{j}"] = bp
            stats[f"stage_{si}_block_{j}"] = bs
    n = len(stages) + 1
    params["last_conv"], stats["last_conv"] = _tv_cna(sd, f"features.{n}.0", f"features.{n}.1")
    _check_done(sd, ignore=("classifier",))
    return {"params": params, "batch_stats": stats}


def convert_regnet(sd_raw: dict, stage_config, se: bool) -> dict:
    """torchvision RegNet X/Y → ours (models/regnet.py). ``stage_config`` is
    [(width, num_blocks, group_width)] from RegNet._stage_config."""
    sd = _SD(sd_raw)
    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = _tv_cna(sd, "stem.0", "stem.1")
    for i, (_w, n, _g) in enumerate(stage_config):
        for j in range(n):
            p = f"trunk_output.block{i+1}.block{i+1}-{j}"
            bp: dict = {}
            bs: dict = {}
            bp["conv1"], bs["conv1"] = _tv_cna(sd, f"{p}.f.a.0", f"{p}.f.a.1")
            bp["conv2"], bs["conv2"] = _tv_cna(sd, f"{p}.f.b.0", f"{p}.f.b.1")
            if se:
                bp["se"] = _tv_se(sd, f"{p}.f.se")
            bp["conv3"], bs["conv3"] = _tv_cna(sd, f"{p}.f.c.0", f"{p}.f.c.1")
            if sd.has(f"{p}.proj.0.weight"):
                bp["downsample"], bs["downsample"] = _tv_cna(sd, f"{p}.proj.0", f"{p}.proj.1")
            params[f"stage_{i}_block_{j}"] = bp
            stats[f"stage_{i}_block_{j}"] = bs
    _check_done(sd, ignore=("fc",))
    return {"params": params, "batch_stats": stats}
