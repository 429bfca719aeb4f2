"""K9 at every distinct stride-1 depthwise shape of a model, on one NVIDIA card.

    python3 scripts/time_depthwise_shapes.py [efficientnet_b0 | mobilenet_v3_large | bifpn ...]

The shapes are read off the model: a forward at 224 px on the meta device
records each ``ConvNormAct`` depthwise branch's input (H, W, C) and k, and
how many of the model's calls share it (``bifpn``: BiFPN(64, 3 layers) on
efficientnet_b0's five taps). Each distinct shape is then run at batch
``BATCH`` in bf16 through ``chip_smoke.time_depthwise_case`` (the kernels,
their plain versions in turns, cuDNN's grouped conv on the same memory, the
bound by bytes or operations, the route and launch geometry; CUDA events)
and, apart from the host's launch cost, as device time per call of the
kernels and of cuDNN (torch.profiler, ``ab_depthwise_conv.device_ms``); the
timed operands are held against the plain versions
(``chip_smoke.hold_depthwise``: bf16 out and dx bit-equal, a second
backward bit-equal). Prints one line per shape and the sums over the
model's calls, writes ``chiprun_out/time_depthwise_shapes.json``. Needs a
CUDA card.
"""

from __future__ import annotations

import collections
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
BATCH = 128
MODELS = ("efficientnet_b0", "mobilenet_v3_large", "bifpn")


def depthwise_shapes(name: str) -> collections.Counter:
    """(H, W, C, k) → calls, from a meta-device forward at 224 px."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.models.necks import BiFPN
    from vision_toolbox_tpu_torch.nn.layers import ConvNormAct

    shapes = collections.Counter()

    def record(module, args):
        x = args[0]
        shapes[(x.shape[1], x.shape[2], x.shape[3], module.conv.weight.shape[-1])] += 1

    with torch.device("meta"), torch.no_grad():
        backbone = vtt.create_backbone("efficientnet_b0" if name == "bifpn" else name,
                                       device="meta")
        x = torch.empty(1, 224, 224, 3)
        model = backbone
        if name == "bifpn":
            x = backbone.get_feature_maps(x)
            model = BiFPN(backbone.out_channels_list, 64, 3, device="meta")
        for m in model.modules():
            if isinstance(m, ConvNormAct) and m.depthwise:
                m.register_forward_pre_hook(record)
        model(x)
    return shapes


def main() -> int:
    if not torch.cuda.is_available():
        print("time_depthwise_shapes: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(MODELS)
    if not set(names) <= set(MODELS):
        print(f"time_depthwise_shapes: models are {MODELS}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from ab_depthwise_conv import device_ms
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = cs.card()
    _cuda.lib()
    report = {"card": name_power, "batch": BATCH, "models": {}}
    g = torch.Generator().manual_seed(18)
    for name in names:
        rows, sums, checks = [], collections.Counter(), cs.Checks()
        for (H, W, C, k), calls in sorted(depthwise_shapes(name).items(), reverse=True):
            assert H == W, (H, W)
            with torch.no_grad():
                row, (x, w, dout) = cs.time_depthwise_case(g, BATCH, H, C, k, name_power,
                                                           tag=f"{name}-depthwise")
                wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                row["forward"]["device_ms"] = device_ms(lambda: dc.depthwise_conv2d_cuda(x, w))
                row["forward"]["library_device_ms"] = device_ms(
                    lambda: F.conv2d(x.permute(0, 3, 1, 2), wc, padding=k // 2, groups=C))
                row["backward"]["device_ms"] = device_ms(
                    lambda: dc.depthwise_conv2d_bwd_cuda(x, w, dout))
                case = dict(kernel="depthwise_conv", B=BATCH, H=H, W=H, C=C, k=k,
                            dtype="bfloat16", route=row["route"])
                _, _, differ = cs.hold_depthwise(checks, case, x, w, dout, second=True)
            row["calls"] = calls
            rows.append(row)
            for what in ("forward", "backward"):
                for key in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms"):
                    sums[f"{what}/{key}"] += calls * row[what][key]
            sums["forward/library_device_ms"] += calls * row["forward"]["library_device_ms"]
            print(f"[{name}] {H}x{H}x{C} k={k} ×{calls}: device time forward "
                  f"{row['forward']['device_ms']:.4f} ms (cuDNN "
                  f"{row['forward']['library_device_ms']:.4f}), backward "
                  f"{row['backward']['device_ms']:.4f}; held {checks.summary(case)}; "
                  f"bf16 elements differing from plain: out {differ[0]}, dx {differ[1]}  "
                  f"[{name_power}]", flush=True)
            del x, w, dout
        print(f"[{name}] summed over its {sum(r['calls'] for r in rows)} calls at b{BATCH}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(sums.items())), flush=True)
        report["models"][name] = dict(shapes=rows, sums=dict(sums), held=checks.rows)
        if not all(r["ok"] for r in checks.rows):
            raise AssertionError(f"K9 at {name}'s shapes out of bounds")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "time_depthwise_shapes.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
