"""The port imports torch and never JAX: a fresh interpreter imports every
module of it, runs a tiny ViT, a narrow SigLIP ViT at T = 1024 (its
attention through the flash op), a tiny CaiT forward and train step, a
narrow ConvNeXt forward and train step (its depthwise convs through the K9
op), a narrow Swin forward and train step (its window attention and
shifted-window relayouts through the K7 and K8 ops), a tiny ViT on the
unfused block chain at 64 (batch·head) pairs, forward and train step (its
attention through the K2 op and autograd function), one full-recipe
train step of a narrow CSP Darknet, a narrow EfficientNet's feature taps
and train step (its depthwise convs through the K9 op) and a BiFPN on
those taps, a 2-step ``Trainer.fit`` on synthetic data and a device-resident
one on a tiny raw-shard directory (the data package, the pinned feed's CPU
path, ``ops/device_rrc.py``, checkpoints), loads a deit_ti_16 file written
in FB's layout without JAX (``tests/official_ckpts.py``) through
``load_pretrained``, quantizes a tiny ViT to int8 and counts its FLOPs,
and must not have loaded ``jax``,
``flax``, ``optax``, ``orbax`` or ``vision_toolbox_tpu``. No source file of
the package, nor ``chip_smoke.py``, imports one of them."""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import ast
import pathlib
import subprocess
import sys

PORT = pathlib.Path(__file__).resolve().parent.parent / "vision_toolbox_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vision_toolbox_tpu")

_PROBE = """
import sys
import torch
import vision_toolbox_tpu_torch as vtt
from vision_toolbox_tpu_torch.utils import export, jax_bridge
from vision_toolbox_tpu_torch.nn import norm
from vision_toolbox_tpu_torch.ops import augment, cait_attention, depthwise_conv, flash_attention, trivial_augment, warp
from vision_toolbox_tpu_torch.ops import short_attention, swin_attention, swin_relayout
from vision_toolbox_tpu_torch.models import cait, convnext, darknet, swin
from vision_toolbox_tpu_torch.models import efficientnet, mbconv, mobilenet, necks, regnet, resnet
from vision_toolbox_tpu_torch.ops import deform_conv
from vision_toolbox_tpu_torch import train
from vision_toolbox_tpu_torch.train import classifier, config, optim, step, tracking, trainer
from vision_toolbox_tpu_torch.train import __main__ as cli
from vision_toolbox_tpu_torch import data
from vision_toolbox_tpu_torch.data import datasets, loader, native, raw_shards, transforms, wds_loader
from vision_toolbox_tpu_torch.ops import device_rrc
from vision_toolbox_tpu_torch.utils import checkpoint
from vision_toolbox_tpu_torch import parallel
from vision_toolbox_tpu_torch.parallel import mesh, sharding
m = vtt.models.ViT(128, 2, 4, 8, 32, device="cpu")
with torch.no_grad():
    out = m(torch.rand(2, 32, 32, 3))
assert out.shape == (2, 128), out.shape
s = vtt.models.ViT(64, 1, 2, 4, 128, cls_token=False, pool_type="mha", device="cpu")
with torch.no_grad():
    out = s(torch.rand(1, 128, 128, 3))
assert out.shape == (1, 64) and torch.isfinite(out).all(), out.shape
c = cait.CaiT(192, 1, 1, 4, 16, 32, dtype=torch.bfloat16, device="cpu")
with torch.no_grad():
    out = c(torch.rand(2, 32, 32, 3))
assert out.shape == (2, 192) and out.dtype == torch.bfloat16, (out.shape, out.dtype)
clf = train.ImageClassifier(c, 10, dtype=torch.bfloat16)
state = train.TrainState(clf, train.sgd_with_param_groups(clf, 0.1))
loss = train.make_train_step(10, compute_dtype=torch.bfloat16)(
    state, torch.rand(4, 32, 32, 3), torch.tensor([1, 2, 3, 4]), torch.Generator().manual_seed(0))
assert torch.isfinite(loss["loss"]), loss
n = convnext.ConvNeXt(32, (1, 1, 1, 1), stochastic_depth=0.1, dtype=torch.bfloat16, device="cpu")
with torch.no_grad():
    out = n(torch.rand(2, 32, 32, 3))
assert out.shape == (2, 256) and torch.isfinite(out.float()).all(), out.shape
clf = train.ImageClassifier(n, 10, dtype=torch.bfloat16)
state = train.TrainState(clf, train.sgd_with_param_groups(clf, 0.1))
loss = train.make_train_step(10, compute_dtype=torch.bfloat16)(
    state, torch.rand(2, 32, 32, 3), torch.tensor([1, 2]), torch.Generator().manual_seed(0))
assert torch.isfinite(loss["loss"]), loss
w = swin.SwinTransformer(32, 32, 2, (2, 2), (4, 4), stochastic_depth=0.1, dtype=torch.bfloat16,
                         device="cpu")
with torch.no_grad():
    out = w(torch.rand(2, 32, 32, 3))
assert out.shape == (2, 64) and torch.isfinite(out.float()).all(), out.shape
clf = train.ImageClassifier(w, 10, dtype=torch.bfloat16)
state = train.TrainState(clf, train.sgd_with_param_groups(clf, 0.1))
loss = train.make_train_step(10, compute_dtype=torch.bfloat16)(
    state, torch.rand(2, 32, 32, 3), torch.tensor([1, 2]), torch.Generator().manual_seed(0))
assert torch.isfinite(loss["loss"]), loss
import functools
u = vtt.models.ViT(64, 1, 8, 8, 32, device="cpu")  # 8 heads of 8: 64 pairs at batch 8
u.forward = functools.partial(type(u).forward, u, force_unfused=True)
calls = []
plain = short_attention.short_attention_plain
short_attention.short_attention_plain = lambda *a: calls.append(1) or plain(*a)
with torch.no_grad():
    out = u(torch.rand(8, 32, 32, 3))
assert out.shape == (8, 64) and torch.isfinite(out).all(), out.shape
clf = train.ImageClassifier(u, 10)
state = train.TrainState(clf, train.sgd_with_param_groups(clf, 0.1))
loss = train.make_train_step(10)(
    state, torch.rand(8, 32, 32, 3), torch.arange(8), torch.Generator().manual_seed(0))
assert torch.isfinite(loss["loss"]) and len(calls) == 2, (loss, calls)
clf = train.ImageClassifier(darknet.Darknet(8, ((1, 16), (1, 32)), csp=True, device="cpu"), 10)
state = train.TrainState(clf, train.sgd_with_param_groups(clf, 0.1))
fn = train.make_train_step(10, trivial_augment=True, random_erasing_p=0.5)
g = torch.Generator().manual_seed(0)
images = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8, generator=g)
loss = fn(state, images, torch.tensor([1, 2, 3, 4]), g)["loss"]
assert torch.isfinite(loss), loss
e = efficientnet.EfficientNet(0.25, 0.25, dtype=torch.bfloat16, device="cpu")
with torch.no_grad():
    taps = e.get_feature_maps(torch.rand(2, 64, 64, 3))
assert [t.shape[-1] for t in taps] == list(e.out_channels_list), [t.shape for t in taps]
clf = train.ImageClassifier(e, 10, dtype=torch.bfloat16)
state = train.TrainState(clf, train.sgd_with_param_groups(clf, 0.1))
loss = train.make_train_step(10, compute_dtype=torch.bfloat16)(
    state, torch.rand(2, 64, 64, 3), torch.tensor([1, 2]), torch.Generator().manual_seed(0))
assert torch.isfinite(loss["loss"]), loss
b = necks.BiFPN(e.out_channels_list, 16, 2, dtype=torch.bfloat16, device="cpu")
with torch.no_grad():
    outs = b([t.to(torch.bfloat16) for t in taps])
assert [o.shape[-1] for o in outs] == [16] * len(taps) and all(
    torch.isfinite(o.float()).all() for o in outs), [o.shape for o in outs]
import tempfile
import numpy as np
with tempfile.TemporaryDirectory() as tmp:
    cfg = config.Config()
    cfg.model.backbone, cfg.model.num_classes, cfg.model.bf16 = "darknet19", 10, False
    cfg.data.synthetic, cfg.data.batch_size, cfg.data.train_size = True, 4, 8
    cfg.data.train_crop_size = cfg.data.val_crop_size = 32
    cfg.train.epochs, cfg.runtime.out_dir = 1, tmp + "/synthetic"
    fit = trainer.Trainer(cfg, device="cpu")
    assert fit.fit().step == 2
    rng = np.random.default_rng(0)
    for part, n in (("train", 8), ("val", 3)):
        raw_shards.write_shard(f"{tmp}/{part}.vtraw", rng.integers(0, 256, (n, 24, 24, 3), np.uint8),
                               rng.integers(0, 4, n))
    import os
    for part in ("train", "val"):
        os.makedirs(f"{tmp}/{part}")
        os.replace(f"{tmp}/{part}.vtraw", f"{tmp}/{part}/0.vtraw")
    cfg.data.synthetic, cfg.data.raw_shards, cfg.data.device_resident = False, True, True
    cfg.data.train_dir, cfg.data.val_dir = tmp + "/train", tmp + "/val"
    cfg.data.train_crop_size, cfg.data.val_crop_size = 16, 24
    cfg.runtime.out_dir = tmp + "/resident"
    fit = trainer.Trainer(cfg, device="cpu")
    assert fit.fit().step == 2 and fit._device_store is not None
    assert os.path.isdir(tmp + "/resident/checkpoints/step_2")
from vision_toolbox_tpu_torch.models import pretrained
from vision_toolbox_tpu_torch.utils import (
    download, flax_ckpt, int8_serving, profile, torch_interop, torch_pth,
)
sys.path.insert(0, "tests")
import official_ckpts  # torch and numpy only
with tempfile.TemporaryDirectory() as tmp:
    os.environ["VTT_CACHE_DIR"] = tmp
    official_ckpts.write("deit_ti_16", tmp)
    d = vtt.load_pretrained("deit_ti_16", device="cpu")
with torch.no_grad():
    out = d(torch.rand(1, 224, 224, 3))
assert out.shape == (1, 192) and torch.isfinite(out).all(), out.shape
q = int8_serving.quantize_model(vtt.models.ViT(128, 2, 4, 8, 32, device="cpu"))
assert sum(isinstance(m, int8_serving.Int8Linear) for m in q.modules()) == 12
with profile.frozen(q), torch.no_grad():
    assert profile.flops(q, torch.rand(2, 32, 32, 3)) > 0
loaded = sorted(n for n in FORBIDDEN if n in sys.modules)
print("LOADED", loaded)
"""


def test_port_runs_without_loading_jax():
    probe = f"FORBIDDEN = {FORBIDDEN!r}\n" + _PROBE
    proc = subprocess.run(
        [sys.executable, "-c", probe], capture_output=True, text=True, timeout=120,
        cwd=PORT.parent,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_no_source_file_imports_jax():
    for path in [*PORT.rglob("*.py"), PORT.parent / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (
                    f"{path.relative_to(PORT.parent)} imports {name}"
                )
