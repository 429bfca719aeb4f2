"""The port's mesh and sharding rules (vision_toolbox_tpu_torch/parallel/),
in one process; the multi-rank legs are in tests/test_torch_multiprocess.py.

- The partition rules against the JAX package's: for vit_b_16, convnext_t
  and cspdarknet53 with a 1000-class head, tp and fsdp, axis size 2 and 4,
  the port's rule on the port's classifier (built on the meta device)
  shards the same parameters as JAX's ``param_partition_spec`` /
  ``fsdp_partition_spec`` over the JAX tree (``jax.eval_shape`` of the
  init), over the same axis, along the same dim mapped through the
  bridge's layout (``utils/jax_bridge.jax_dims``).
- Optimizer buffers follow their parameter by name, not by shape, as
  tests/test_train_step.py:180 holds the JAX package's: two same-shaped
  parameters with different specs keep distinct buffer shards.
- The mesh's checks: a product of axis sizes other than the world size
  raises ``ValueError``, and so does a batch remainder over the data axis.
- Gather-at-use on one process: a sharded model computes what the whole
  one does, and its checkpoint holds whole tensors.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from vision_toolbox_tpu.models.base import create_backbone as jax_backbone
from vision_toolbox_tpu.parallel import sharding as jsharding
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu_torch.models.base import create_backbone
from vision_toolbox_tpu_torch.parallel import (
    Mesh,
    batch_rows,
    create_mesh,
    partition_specs,
    shard_train_state,
)
from vision_toolbox_tpu_torch.parallel.sharding import shard_of
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_optimizer,
    make_train_step,
)
from vision_toolbox_tpu_torch.utils.checkpoint import whole_state
from vision_toolbox_tpu_torch.utils.jax_bridge import _convert, jax_dims

MODELS = ("vit_b_16", "convnext_t", "cspdarknet53")


def _jax_specs(name: str, fsdp: bool, size: int) -> dict[str, tuple]:
    """JAX's spec of every parameter of ``name``'s classifier, keyed by the
    bridge's port name, as (axis, port dim) or None."""
    model = JaxClassifier(backbone=jax_backbone(name), num_classes=1000)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 224, 224, 3)), train=False))
    sizes = (size,) if fsdp else (1, size)
    axes = ("data",) if fsdp else ("data", "model")
    mesh = JaxMesh(np.asarray(jax.devices()[:size]).reshape(sizes), axes)
    rule = jsharding.fsdp_partition_spec if fsdp else jsharding.param_partition_spec
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        keys = tuple(k.key for k in path)
        port_name, _ = _convert(keys, np.broadcast_to(np.float32(0), leaf.shape))
        spec = tuple(rule(path, leaf, mesh))
        axis = [(d, a) for d, a in enumerate(spec) if a is not None]
        out[port_name] = None
        if axis:
            (jdim, a), = axis
            out[port_name] = (a, jax_dims(port_name, leaf.ndim)[jdim])
    return out


def _port_classifier(name: str) -> ImageClassifier:
    with torch.device("meta"):
        backbone = create_backbone(name, device="meta")
        return ImageClassifier(backbone, 1000)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("sharding", ["tp", "fsdp"])
@pytest.mark.parametrize("name", MODELS)
def test_partition_rules_match_jax(name, sharding, size):
    fsdp = sharding == "fsdp"
    want = _jax_specs(name, fsdp, size)
    mesh = Mesh(("data",), (size,)) if fsdp else Mesh(("data", "model"), (1, size))
    specs = partition_specs(_port_classifier(name), mesh, fsdp=fsdp)
    got = {}
    for pname, spec in specs.items():
        axis = [(d, a) for d, a in enumerate(spec) if a is not None]
        got[pname] = (axis[0][1], axis[0][0]) if axis else None
    assert got.keys() == want.keys()
    sharded = {k for k, v in want.items() if v}
    assert sharded, f"{name}: no parameter is sharded"
    assert {k for k, v in got.items() if v} == sharded
    assert {k: v[0] for k, v in got.items() if v} == {k: v[0] for k, v in want.items() if v}
    assert got == want


def _tiny_state():
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Module()
    model.a = torch.nn.Linear(8, 8)
    model.b = torch.nn.Linear(8, 8)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    opt = make_optimizer("sgd", model, 0.1, momentum=0.9)
    return TrainState(model, opt)


def _momentum(state) -> dict:
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: b for (_, ps), bs in zip(state.optimizer.groups,
                                                   state.optimizer.buffers)
            for p, b in zip(ps, bs)}


def test_optimizer_buffers_follow_their_parameter_by_name():
    """Two (8, 8) weights, one sharded over a 2-way model axis and one not:
    after a step (buffers exist, whole) the sharding slices each buffer as
    its own parameter, matched by the parameter it belongs to."""
    state = _tiny_state()
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    (state.model.a(x).sum() + state.model.b(x).sum()).backward()
    state.optimizer.step()
    whole = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    momentum = {n: b.clone() for n, b in _momentum(state).items()}
    assert momentum["a.weight"].shape == momentum["b.weight"].shape == (8, 8)
    # a stand-in for rank 1 of {"data": 1, "model": 2}: no process group,
    # so the shard is taken without a collective
    mesh = Mesh(("data", "model"), (1, 2), rank=1)
    rule = lambda name, p: ("model", None) if name == "a.weight" else ()
    shard_train_state(state, mesh, rule_fn=rule)
    params = dict(state.model.named_parameters())
    assert tuple(params["a.weight"].shape) == (4, 8)
    assert tuple(params["b.weight"].shape) == (8, 8)
    assert torch.equal(params["a.weight"], whole["a.weight"][4:])
    buffers = _momentum(state)
    assert torch.equal(buffers["a.weight"], momentum["a.weight"][4:])
    assert torch.equal(buffers["b.weight"], momentum["b.weight"])
    assert shard_of(params["a.weight"]).axis == "model"
    assert shard_of(params["b.weight"]) is None


def test_mesh_product_must_be_the_world_size():
    assert create_mesh().shape == {"data": 1}
    assert create_mesh(("data", "model"), (1, 1)).coords == {"data": 0, "model": 0}
    for sizes in ((2,), (1, 2), (2, 2)):
        axes = ("data", "model")[:len(sizes)]
        with pytest.raises(ValueError, match="the world has 1"):
            create_mesh(axes, sizes)


def test_batch_rows_follow_the_data_coordinate():
    """Rows of a 16-image batch on a {"data": 2, "model": 2} grid: ranks
    laid out row-major, the same rows for ranks that differ only on model;
    a remainder raises."""
    rows = [batch_rows(Mesh(("data", "model"), (2, 2), rank=r), 16) for r in range(4)]
    assert rows == [slice(0, 8), slice(0, 8), slice(8, 16), slice(8, 16)]
    assert Mesh(("data", "model"), (2, 2), rank=2).coords == {"data": 1, "model": 0}
    with pytest.raises(ValueError, match="does not divide"):
        batch_rows(Mesh(("data",), (2,)), 15)


def test_gather_at_use_on_one_process_is_the_whole_model():
    """A narrow ViT whose projections are 'sharded' over a 1-way axis (no
    process group) trains bit for bit as the whole one; its checkpoint
    payload holds whole tensors under the whole names."""
    from vision_toolbox_tpu_torch.models.vit import ViT

    def state():
        gen = torch.Generator().manual_seed(0)
        model = ImageClassifier(ViT(128, 2, 4, 8, 32, device="cpu", generator=gen), 10,
                                generator=gen)
        return TrainState(model, make_optimizer("sgd", model, 0.1))

    a, b = state(), state()
    shard_train_state(b, Mesh(("data", "model"), (1, 1)), min_size=4096)
    assert any(shard_of(p) for p in b.model.parameters())
    step = make_train_step(10)
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([1, 2, 3, 4])
    for s in (a, b):
        for i in range(2):
            step(s, x, y, torch.Generator().manual_seed(i))
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), n
    payload = whole_state(b)
    assert payload["model"].keys() == a.model.state_dict().keys()
