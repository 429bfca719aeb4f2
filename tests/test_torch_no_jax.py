"""The port imports torch and never JAX: a fresh interpreter imports every
module of it, runs a tiny ViT and one full-recipe train step of a narrow CSP
Darknet, and must not have loaded ``jax`` or ``flax``."""

import ast
import pathlib
import subprocess
import sys

PORT = pathlib.Path(__file__).resolve().parent.parent / "vision_toolbox_tpu_torch"

_PROBE = """
import sys
import torch
import vision_toolbox_tpu_torch as vtt
from vision_toolbox_tpu_torch.utils import export, jax_bridge
from vision_toolbox_tpu_torch.nn import norm
from vision_toolbox_tpu_torch.ops import augment, trivial_augment, warp
from vision_toolbox_tpu_torch.models import darknet
from vision_toolbox_tpu_torch import train
from vision_toolbox_tpu_torch.train import classifier, optim, step
m = vtt.models.ViT(128, 2, 4, 8, 32, device="cpu")
with torch.no_grad():
    out = m(torch.rand(2, 32, 32, 3))
assert out.shape == (2, 128), out.shape
clf = train.ImageClassifier(darknet.Darknet(8, ((1, 16), (1, 32)), csp=True, device="cpu"), 10)
state = train.TrainState(clf, train.sgd_with_param_groups(clf, 0.1))
fn = train.make_train_step(10, trivial_augment=True, random_erasing_p=0.5)
g = torch.Generator().manual_seed(0)
images = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8, generator=g)
loss = fn(state, images, torch.tensor([1, 2, 3, 4]), g)["loss"]
assert torch.isfinite(loss), loss
loaded = sorted(n for n in ("jax", "jaxlib", "flax") if n in sys.modules)
print("LOADED", loaded)
"""


def test_port_runs_without_loading_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=120,
        cwd=PORT.parent,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_no_source_file_imports_jax():
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "vision_toolbox_tpu"), (
                    f"{path.relative_to(PORT.parent)} imports {name}"
                )
