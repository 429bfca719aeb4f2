"""Serving export of the port (vision_toolbox_tpu_torch/utils/export.py):
export → bytes → load gives the eager model's outputs exactly on CPU, at
batch sizes other than the one traced, with the fused half-blocks carried
through the program as custom ops."""

import io

import torch

from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.utils.export import export_model, load_exported

TINY = dict(d_model=128, depth=2, n_heads=4, patch_size=8, img_size=32)


def test_export_roundtrip_matches_eager():
    model = ViT(**TINY)
    blob = export_model(model, (2, 32, 32, 3))
    assert isinstance(blob, bytes)
    served = load_exported(blob)
    for batch in (1, 2, 5):
        x = torch.rand(batch, 32, 32, 3, generator=torch.Generator().manual_seed(batch))
        with torch.no_grad():
            want = model(x)
            got = served(x)
        assert torch.equal(got, want), batch


def test_exported_program_calls_the_fused_ops():
    model = ViT(**{**TINY, "depth": 1})
    program = torch.export.load(io.BytesIO(export_model(model, (2, 32, 32, 3))))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("vtt.fused_attention_block.default") == 1
    assert targets.count("vtt.fused_mlp_block.default") == 1


def test_export_bf16():
    model = ViT(**TINY, dtype=torch.bfloat16)
    served = load_exported(export_model(model, (3, 32, 32, 3)))
    x = torch.rand(3, 32, 32, 3)
    with torch.no_grad():
        assert torch.equal(served(x), model(x))
