"""Where the time of a served request goes, on one NVIDIA card.

    python3 scripts/profile_torch_serve.py [cait_s_24 | vit_b_16 | vit_b_16_dropout | convnext_t
                                            | mixer_b_16 | patchconvnet_s | vovnet57] [--root DIR]

Builds the seeded bf16 model of one of ``chip_smoke.py``'s serving phases
(cait_s_24 by default, its LayerScale γs spread as there; vit_b_16, 12 K3
and 12 K4 forwards a request; vit_b_16 built with dropout 0.1, whose blocks
run the module chain and K2; or convnext_t,
18 K9 and 18 K3 forwards a request, its γs spread around
``CONVNEXT_TRAIN["layer_scale"]``; mixer_b_16, 12 K3 forwards a request;
patchconvnet_s, 60 K9 forwards a request, its γs spread around
``PATCHCONV_TRAIN["layer_scale"]``; or vovnet57, no kernel), exports it with
``utils/export.py`` and loads it back, then for each of ``SERVE_BATCHES``
times 10 requests to the loaded program and to the eager model with CUDA
events, measures the host's enqueue time of a request (host clock around
the call, no synchronisation), and traces 5 requests with
``torch.profiler``: device kernel time per request, by kernel, against the
profiled window (idle share = 1 − kernel time / window). Prints a table and
one JSON line and writes ``chiprun_out/profile_<model>_serve.json``.
``--root DIR`` imports the package and ``chip_smoke.py`` from another
checkout (an earlier revision unpacked with ``git archive`` into a
git-ignored directory), so two revisions are compared in turns, one process
each (both packages share one name): earlier, this, this, earlier; the file
is then ``profile_<model>_serve_<DIR's name>.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
TRACED = 5


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    configs = ("cait_s_24", "vit_b_16", "vit_b_16_dropout", "convnext_t", "mixer_b_16",
               "patchconvnet_s", "vovnet57")
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("model", nargs="?", default="cait_s_24", choices=configs)
    parser.add_argument("--root", type=Path, default=None,
                        help="checkout to import the package and chip_smoke.py from")
    args = parser.parse_args()
    sys.path.insert(0, str((args.root or ROOT).resolve()))
    import chip_smoke
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.utils.export import export_model, load_exported

    tag = args.model
    # tag → (backbone, backbone options, LayerScale centre)
    name, model_kw, layer_scale = {
        "cait_s_24": ("cait_s_24", {}, chip_smoke.CAIT_LAYER_SCALE),
        "vit_b_16": ("vit_b_16", {}, None),
        "vit_b_16_dropout": ("vit_b_16", chip_smoke.VIT_DROPOUT, None),
        "convnext_t": ("convnext_t", {}, chip_smoke.CONVNEXT_TRAIN["layer_scale"]),
        "mixer_b_16": ("mixer_b_16", {}, None),
        "patchconvnet_s": ("patchconvnet_s", {}, chip_smoke.PATCHCONV_TRAIN["layer_scale"]),
        "vovnet57": ("vovnet57", {}, None),
    }[tag]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card()
    model = vtt.create_backbone(name, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0), **model_kw)
    if layer_scale is not None:
        chip_smoke.spread_layer_scale(model, layer_scale)
    model.eval()
    served = load_exported(export_model(model, (8, 224, 224, 3)))
    images = torch.rand(32, 224, 224, 3, generator=torch.Generator().manual_seed(1)).cuda()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows = []
    with torch.inference_mode():
        for b in chip_smoke.SERVE_BATCHES:
            x = images[:b]
            served_ms = chip_smoke.time_ms(lambda: served(x), iters=10)
            eager_ms = chip_smoke.time_ms(lambda: model(x), iters=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRACED):
                served(x)
            enqueue_ms = (time.perf_counter() - t0) * 1e3 / TRACED
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(TRACED):
                    served(x)
                torch.cuda.synchronize()
                window = (time.perf_counter() - t0) * 1e3 / TRACED
            kernels = collections.defaultdict(float)
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                        e, "is_user_annotation", False):
                    kernels[e.name] += e.time_range.elapsed_us() / 1e3 / TRACED
            kernel_ms = sum(kernels.values())
            top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
            rows.append(dict(batch=b, served_ms=served_ms, eager_ms=eager_ms,
                             host_enqueue_ms=enqueue_ms, profiled_window_ms=window,
                             kernel_ms=kernel_ms, idle_share=1 - kernel_ms / window,
                             top_kernels_ms=top))
            print(f"{tag} ({args.root or 'this checkout'}) batch {b:2d} [{card}]: served {served_ms:.3f} ms, eager {eager_ms:.3f} "
                  f"ms, host enqueue {enqueue_ms:.3f} ms; profiled window {window:.3f} ms, "
                  f"kernels {kernel_ms:.3f} ms, idle share {1 - kernel_ms / window:.3f}")
            for k, ms in top.items():
                print(f"    {ms:8.3f} ms  {k[:100]}")
    result = dict(card=card, model=tag, root=str(args.root or "."), requests=rows)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    suffix = f"_{args.root.resolve().name}" if args.root else ""
    (out / f"profile_{tag}_serve{suffix}.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({**result, "requests": [{k: v for k, v in r.items() if k != "top_kernels_ms"}
                                             for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
