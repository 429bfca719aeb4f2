"""Upstream Flax ``.npz`` checkpoints (AugReg ViT, SigLIP, MLP-Mixer) → the
JAX-layout parameter tree — a copy of ``vision_toolbox_tpu/utils/flax_ckpt.py``
(numpy only), kept in the port so that it imports nothing of the JAX
package; ``models/pretrained.py`` bridges the tree to the port's state dict.
The files are already in the JAX layout: only the packed attention heads are
reshaped and the AugReg cls-token PE split (reference vit.py:215-263,
mlp_mixer.py:86-100).

AugReg (vision_transformer repo): gs://vit_models/augreg/...npz
SigLIP (big_vision): gs://big_vision/siglip/...npz with prefix "params/img/"
Mixer: gs://mixer_models/...npz
"""

from __future__ import annotations

import numpy as np


def _ln(w: dict, prefix: str) -> dict:
    return {"scale": w.pop(f"{prefix}/scale"), "bias": w.pop(f"{prefix}/bias")}


def _dense(w: dict, prefix: str) -> dict:
    return {"kernel": w.pop(f"{prefix}/kernel"), "bias": w.pop(f"{prefix}/bias")}


def _mha(w: dict, prefix: str) -> dict:
    """Packed (d, H, Dh) q/k/v and (H, Dh, d) out → flat (d, d) kernels."""
    out = {}
    for name in ("query", "key", "value"):
        kernel = w.pop(f"{prefix}/{name}/kernel")
        bias = w.pop(f"{prefix}/{name}/bias")
        d = kernel.shape[0]
        out[f"{name[0]}_proj"] = {
            "kernel": kernel.reshape(d, -1),
            "bias": bias.reshape(-1),
        }
    kernel = w.pop(f"{prefix}/out/kernel")
    d = kernel.shape[-1]
    out["out_proj"] = {
        "kernel": kernel.reshape(-1, d),
        "bias": w.pop(f"{prefix}/out/bias").reshape(-1),
    }
    return out


def load_vit_npz(path: str, depth: int, *, big_vision: bool = False, prefix: str = "") -> dict:
    """Build our ViT 'params' tree from an AugReg / big_vision .npz
    (reference layout notes at vit.py:216-231)."""
    raw = np.load(path)
    w = {k[len(prefix):]: np.asarray(v) for k, v in raw.items() if k.startswith(prefix)}

    if big_vision:
        mha_norm, mha = "LayerNorm_0", "MultiHeadDotProductAttention_0"
        mlp_norm, mlp = "LayerNorm_1", "MlpBlock_0"
    else:
        mha_norm, mha = "LayerNorm_0", "MultiHeadDotProductAttention_1"
        mlp_norm, mlp = "LayerNorm_2", "MlpBlock_3"

    params: dict = {}
    if big_vision:
        params["pe"] = w.pop("pos_embedding")
        if "cls" in w:
            params["cls_token"] = w.pop("cls")
    else:
        pe = w.pop("Transformer/posembed_input/pos_embedding")
        # reference folds the cls-token PE into the cls token (vit.py:241-243)
        params["cls_token"] = w.pop("cls") + pe[:, :1]
        params["pe"] = pe[:, 1:]

    params["patch_embed"] = _dense(w, "embedding")
    params["norm"] = _ln(w, "Transformer/encoder_norm")

    for i in range(depth):
        p = f"Transformer/encoderblock_{i}"
        params[f"block_{i}"] = {
            "mha_norm": _ln(w, f"{p}/{mha_norm}"),
            "mha": _mha(w, f"{p}/{mha}"),
            "mlp_norm": _ln(w, f"{p}/{mlp_norm}"),
            "mlp": {
                "linear1": _dense(w, f"{p}/{mlp}/Dense_0"),
                "linear2": _dense(w, f"{p}/{mlp}/Dense_1"),
            },
        }

    if "MAPHead_0/probe" in w:  # SigLIP MAP pooling head (vit.py:254-260)
        params["pooler"] = {
            "probe": w.pop("MAPHead_0/probe"),
            "mha": _mha(w, "MAPHead_0/MultiHeadDotProductAttention_0"),
            "norm": _ln(w, "MAPHead_0/LayerNorm_0"),
            "mlp": {
                "linear1": _dense(w, "MAPHead_0/MlpBlock_0/Dense_0"),
                "linear2": _dense(w, "MAPHead_0/MlpBlock_0/Dense_1"),
            },
        }

    leftovers = [k for k in w if not k.startswith("head")]
    if leftovers:
        raise ValueError(f"unconsumed checkpoint entries: {leftovers}")
    return params


def load_mixer_npz(path: str, n_layers: int) -> dict:
    """Build our MLPMixer 'params' tree from a mixer_models .npz
    (reference layout at mlp_mixer.py:86-100)."""
    w = {k: np.asarray(v) for k, v in np.load(path).items()}
    params: dict = {
        "patch_embed": _dense(w, "stem"),
        "norm": _ln(w, "pre_head_layer_norm"),
    }
    for i in range(n_layers):
        p = f"MixerBlock_{i}"
        params[f"block_{i}"] = {
            "norm1": _ln(w, f"{p}/LayerNorm_0"),
            "token_mixing": {
                "linear1": _dense(w, f"{p}/token_mixing/Dense_0"),
                "linear2": _dense(w, f"{p}/token_mixing/Dense_1"),
            },
            "norm2": _ln(w, f"{p}/LayerNorm_1"),
            "channel_mixing": {
                "linear1": _dense(w, f"{p}/channel_mixing/Dense_0"),
                "linear2": _dense(w, f"{p}/channel_mixing/Dense_1"),
            },
        }
    leftovers = [k for k in w if not k.startswith("head")]
    if leftovers:
        raise ValueError(f"unconsumed checkpoint entries: {leftovers}")
    return params
