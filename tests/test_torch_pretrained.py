"""The port's checkpoint interop against the JAX package's.

- Loaded state dicts: for every family of ``scripts/make_goldens.py``'s
  GOLDEN_SPECS, the file ``tests/ckpt_builders.py`` plants (the official
  layout at full size) is loaded by both packages; the port's
  ``load_pretrained(..., device="cpu")`` state dict is bit-equal to the
  bridged (``utils/jax_bridge.flax_to_state_dict``) variables of the JAX
  ``load_pretrained``, key for key (the port loads it with ``strict=True``,
  so nothing is missing or unexpected either).
- The reader: ``utils/torch_pth.load_pth`` returns what the JAX package's
  torch-free reader returns (the cases of ``tests/test_interop.py``), and
  both refuse a global outside their allowed set.
- One loaded forward: deit_ti_16 at 224 px, batch 2, f32, on the port's
  main path, against the JAX package's forward of the same file, by the
  repo's parity rule (``tests/torch_parity.py``; measured 4.6e-5 max abs).
"""

import argparse
import pickle
import sys
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from ckpt_builders import plant  # noqa: E402
from torch_parity import assert_matches_kernel  # noqa: E402

from scripts.make_goldens import GOLDEN_SPECS  # noqa: E402
from vision_toolbox_tpu.models.pretrained import load_pretrained as jax_load_pretrained  # noqa: E402
from vision_toolbox_tpu.utils.torch_pth import load_pth as jax_load_pth  # noqa: E402
from vision_toolbox_tpu_torch import load_pretrained  # noqa: E402
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict  # noqa: E402
from vision_toolbox_tpu_torch.utils.torch_pth import load_pth  # noqa: E402


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    """A download cache holding only what the test plants; emptied after it
    (the planted files are full size)."""
    monkeypatch.setenv("VTT_CACHE_DIR", str(tmp_path))
    yield tmp_path
    for f in tmp_path.iterdir():
        f.unlink()


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name,img_size,kwargs", [
    pytest.param(n, s, kw, id=n + ("_siglip" if kw.get("weights") == "siglip" else ""))
    for n, s, kw in GOLDEN_SPECS])
def test_loaded_state_dict_is_the_bridged_jax_load(cache, name, img_size, kwargs):
    plant(name + ("_siglip" if kwargs.get("weights") == "siglip" else ""), cache)
    _, variables = jax_load_pretrained(name, img_size=img_size, **kwargs)
    want = flax_to_state_dict(_numpy(variables["params"]), _numpy(variables.get("batch_stats")))
    model = load_pretrained(name, img_size=img_size, device="cpu", **kwargs)
    got = model.state_dict()
    assert set(got) == set(want), (sorted(set(got) - set(want))[:5],
                                   sorted(set(want) - set(got))[:5])
    for k, t in got.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[k]), k
    assert all(not p.is_meta and p.requires_grad for p in model.parameters())


def _assert_same_tree(got, want):
    assert type(got) is type(want) or (isinstance(got, dict) and isinstance(want, dict)), (
        type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


_READER_CASES = {
    "tensors": lambda: {
        "a.weight": torch.randn(4, 3, 3, 3), "b.bias": torch.randn(7),
        "c.half": torch.randn(5).half(), "d.bf16": torch.randn(6).bfloat16(),
        "e.long": torch.arange(5), "f.noncontig": torch.randn(6, 8).t(),
        "g.scalar": torch.tensor(3.5)},
    "bf16": lambda: {"w": (torch.randn(3, 5) * 100).bfloat16()},
    "nested": lambda: {"model": {"x": torch.ones(2, 2)}, "epoch": 3},
    "model_wrapper": lambda: {"model": OrderedDict(
        [("blocks.0.attn.qkv.weight", torch.nn.Parameter(torch.randn(6, 2))),
         ("cls_token", torch.zeros(1, 1, 2))])},
}


@pytest.mark.parametrize("case", list(_READER_CASES))
def test_load_pth_matches_the_jax_reader(tmp_path, case):
    torch.manual_seed(0)
    path = tmp_path / f"{case}.pth"
    torch.save(_READER_CASES[case](), path)
    _assert_same_tree(load_pth(str(path)), jax_load_pth(str(path)))


def test_load_pth_refuses_what_the_jax_reader_refuses(tmp_path):
    """A training script's ``argparse.Namespace`` beside the weights:
    outside torch's ``weights_only`` set and the JAX reader's."""
    path = tmp_path / "args.pth"
    torch.save({"model": {"w": torch.ones(2)}, "args": argparse.Namespace(lr=0.1)}, path)
    with pytest.raises(pickle.UnpicklingError):
        jax_load_pth(str(path))
    with pytest.raises(pickle.UnpicklingError):
        load_pth(str(path))


def test_unregistered_checkpoints_raise(cache):
    """A name or size without a file in the tables raises ``KeyError``, as
    the JAX function does; an AugReg ViT at another size ``ValueError``."""
    for name, size in (("vit_m_16", 224), ("deit_s_16", 384), ("patchconvnet_s", 224)):
        with pytest.raises(KeyError):
            load_pretrained(name, img_size=size, device="cpu")
    with pytest.raises(ValueError):
        load_pretrained("vit_b_16", img_size=384, device="cpu")


def test_loaded_deit_forward_matches_jax(cache):
    plant("deit_ti_16", cache)
    jax_model, variables = jax_load_pretrained("deit_ti_16")
    x = np.random.default_rng(0).random((2, 224, 224, 3), dtype=np.float32)
    want = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, jnp.asarray(x))
    model = load_pretrained("deit_ti_16", device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 192)
    assert_matches_kernel(got.numpy(), np.asarray(want))
