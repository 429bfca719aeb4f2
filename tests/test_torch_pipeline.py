"""The pipeline's layouts, rules and one-rank paths, and ``token_sharding``
at a seq axis of 1, in one process (vision_toolbox_tpu_torch/
parallel/pipeline.py, models/vit.py); the multi-rank legs are in
tests/test_torch_mp_pipeline.py.

- The layouts against the JAX package's: ``_interleave_order`` at
  (12, 4, 3), (12, 2, 3) and (8, 2, 4); ``classifier_params_to_pipeline``
  and back on the port's state dict against JAX's on the same tree (drawn
  on ``jax.eval_shape`` of the JAX init, carried by ``utils/jax_bridge``)
  for vit_ti_16, deit_ti_16, a CaiT (``sa_block_``) and a Mixer, plain and
  interleaved.
- ``pipeline_apply``'s rules (tests/test_pipeline.py's rejections), the
  refusal of an unknown ViT subclass, and each rank's layers.
- At a pipe axis of 1 (the card's world-1 path) the pipelined classifier is
  the sequential one bit for bit, forward and train step, and its pipeline
  layout round-trips; at a seq axis of 1 a token-sharded ViT is the
  ``force_unfused`` model bit for bit, forward and gradients.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
import torch
from torch_convnets import random_variables
from torch_mp_pipeline_worker import ToyLayer, toy_stage

import jax
import jax.numpy as jnp

from vision_toolbox_tpu import create_backbone as jax_backbone
from vision_toolbox_tpu.models.cait import CaiT as JaxCaiT
from vision_toolbox_tpu.models.mlp_mixer import MLPMixer as JaxMixer
from vision_toolbox_tpu.parallel import pipeline as jpipe
from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu_torch.models.base import create_backbone
from vision_toolbox_tpu_torch.models.cait import CaiT
from vision_toolbox_tpu_torch.models.vit import ViT
from vision_toolbox_tpu_torch.parallel import pipeline
from vision_toolbox_tpu_torch.parallel.mesh import Mesh, TokenSharding, create_mesh
from vision_toolbox_tpu_torch.parallel.sharding import reduce_gradients
from vision_toolbox_tpu_torch.train import ImageClassifier, make_optimizer
from vision_toolbox_tpu_torch.train.classifier import cross_entropy
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

JAX_MODELS = {
    "vit_ti_16": (lambda: jax_backbone("vit_ti_16", img_size=32), "block_", 12),
    "deit_ti_16": (lambda: jax_backbone("deit_ti_16", img_size=32), "block_", 12),
    "cait": (lambda: JaxCaiT(d_model=32, sa_depth=8, ca_depth=2, n_heads=2, patch_size=16,
                             img_size=32), "sa_block_", 8),
    "mixer": (lambda: JaxMixer(n_layers=8, d_model=32, patch_size=16, img_size=32), "block_", 8),
}


@pytest.mark.parametrize("depth,stages,interleave", [(12, 4, 3), (12, 2, 3), (8, 2, 4)])
def test_interleave_order_matches_jax(depth, stages, interleave):
    got = pipeline._interleave_order(depth, stages, interleave)
    np.testing.assert_array_equal(got, jpipe._interleave_order(depth, stages, interleave))
    for d in range(stages):  # each device's segment of it is what that device holds
        n = depth // stages
        assert (pipeline.owned_layers(depth, stages, interleave, d)
                == got[d * n:(d + 1) * n].tolist())


def _jax_classifier_params(name: str) -> dict:
    make, _, _ = JAX_MODELS[name]
    clf = JaxClassifier(backbone=make(), num_classes=10)
    shapes = jax.eval_shape(lambda: clf.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                             train=False))
    return random_variables({"params": shapes["params"]}, seed=3)["params"]


@pytest.mark.parametrize("name", list(JAX_MODELS))
@pytest.mark.parametrize("stages,interleave", [(4, 1), (2, 2)])
def test_classifier_params_to_pipeline_matches_jax(name, stages, interleave):
    """The port's pipeline layout of a classifier's state dict holds JAX's
    stacked leaves (layer l of ``backbone_stacked`` is JAX's layer l, in
    device-major chunk order) and JAX's rest, and converts back to the
    state dict it came from."""
    _, prefix, depth = JAX_MODELS[name]
    params = _jax_classifier_params(name)
    port_prefix = "sa_blocks." if name == "cait" else "blocks."
    state = flax_to_state_dict(params)
    got = pipeline.classifier_params_to_pipeline(state, port_prefix, stages, interleave)
    want = jpipe.classifier_params_to_pipeline(params, prefix, stages, interleave)
    stacked = {k: v for k, v in got.items() if k.startswith("backbone_stacked.")}
    assert {v.shape[0] for v in stacked.values()} == {depth}
    for layer in range(depth):
        block = flax_to_state_dict({f"{prefix}0": jax.tree.map(lambda a, i=layer: a[i],
                                                               want["backbone_stacked"])})
        for k, v in block.items():
            rel = k.split(".", 2)[2]
            np.testing.assert_array_equal(stacked[f"backbone_stacked.{rel}"][layer].numpy(),
                                          v.numpy(), err_msg=f"{name} layer {layer} {rel}")
    rest = flax_to_state_dict({"backbone": want["backbone"], "head": want["head"]})
    assert rest.keys() == {k for k in got if not k.startswith("backbone_stacked.")}
    for k, v in rest.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    back = pipeline.classifier_params_from_pipeline(got, port_prefix, stages, interleave)
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def test_stack_unstack_roundtrip():
    model = create_backbone("vit_ti_16", img_size=32, device="cpu")
    state = model.state_dict()
    stacked, rest = pipeline.stack_block_params(state)
    assert {v.shape[0] for v in stacked.values()} == {12}
    assert not any(k.startswith("blocks.") for k in rest)
    back = pipeline.unstack_block_params(stacked, rest)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], v) for k, v in state.items())
    with pytest.raises(ValueError, match="no 'sa_blocks.\\*' blocks"):
        pipeline.stack_block_params(state, "sa_blocks.")


def _toy_layers(L: int):
    g = torch.Generator().manual_seed(0)
    return [ToyLayer(torch.randn(16, 16, generator=g), torch.randn(16, generator=g))
            for _ in range(L)]


def test_pipeline_apply_rejections():
    """tests/test_pipeline.py's rejections, with its messages: depth over
    the stages (and chunks), M > S when interleaved, the microbatch over
    the data axis. The rules are checked before any rank communicates, so
    a mesh record without process groups stands for the ranks here."""
    pipe4 = Mesh(("pipe",), (4,))
    with pytest.raises(ValueError, match="not divisible by 4 pipeline"):
        pipeline.pipeline_apply(toy_stage, _toy_layers(6), torch.zeros(8, 16), mesh=pipe4)
    with pytest.raises(ValueError, match="microbatch"):
        pipeline.pipeline_apply(toy_stage, _toy_layers(8), torch.zeros(4, 16),
                                mesh=Mesh(("data", "pipe"), (2, 4)), batch_axis="data",
                                num_microbatches=8)
    with pytest.raises(ValueError, match="microbatches <= stages"):
        pipeline.pipeline_apply(toy_stage, _toy_layers(8), torch.zeros(16, 16), mesh=pipe4,
                                num_microbatches=8, interleave=2)
    with pytest.raises(ValueError, match="interleaved chunks"):
        pipeline.pipeline_apply(toy_stage, _toy_layers(12), torch.zeros(16, 16), mesh=pipe4,
                                num_microbatches=4, interleave=2)
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 microbatches"):
        pipeline.pipeline_apply(toy_stage, _toy_layers(8), torch.zeros(6, 16), mesh=pipe4)


def test_pipeline_rejects_unknown_subclass():
    """A ViT subclass the family forwards do not cover fails loudly instead
    of computing another model."""

    class Weird(ViT):
        pass

    weird = Weird(d_model=192, depth=12, n_heads=3, patch_size=16, img_size=32, device="cpu")
    with pytest.raises(ValueError, match="mirrors ViT/DeiT"):
        pipeline.vit_pipeline_forward(weird, torch.zeros(8, 32, 32, 3),
                                      mesh=Mesh(("pipe",), (4,)))
    with pytest.raises(ValueError, match="mirrors ViT/DeiT"):
        pipeline.make_classifier_pipeline_apply(ImageClassifier(weird, 10), Mesh(("pipe",), (4,)))


@pytest.mark.parametrize("name", ["vit_ti_16", "cait"])
def test_one_stage_is_the_sequential_model(name):
    """A pipe axis of 1 (no process group: the card's world-1 path) runs the
    blocks on the whole batch: the logits, one SGD step's loss and every
    gradient bit-equal the sequential classifier's, and the model's
    pipeline layout round-trips through ``load_pipeline_state``."""
    def build():
        g = torch.Generator().manual_seed(1)
        bb = (create_backbone("vit_ti_16", img_size=32, device="cpu", generator=g)
              if name == "vit_ti_16" else
              CaiT(d_model=32, sa_depth=4, ca_depth=2, n_heads=2, patch_size=16, img_size=32,
                   device="cpu", generator=g))
        return ImageClassifier(bb, 10, generator=g)

    mesh = create_mesh(("data", "pipe"), (1, 1))
    seq, pc = build(), pipeline.make_classifier_pipeline_apply(build(), mesh, remat=True)
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    y = torch.tensor([1, 2, 3, 4])
    for model in (seq, pc):
        cross_entropy(model(x, train=True), y).backward()
    reduce_gradients(pc, mesh)
    grads = dict(seq.named_parameters())
    assert [n for n, _ in pc.named_parameters()] == list(grads)
    for n, p in pc.named_parameters():
        assert torch.equal(p.grad, grads[n].grad), n
    with torch.no_grad():
        assert torch.equal(pc(x), seq(x))
    opt = make_optimizer("sgd", pc, 0.1)
    opt.step()
    payload = pc.pipeline_state(opt)
    assert any(k.startswith("backbone_stacked.") for k in payload["model"])
    fresh = pipeline.make_classifier_pipeline_apply(build(), mesh)
    fresh_opt = make_optimizer("sgd", fresh, 0.1)
    fresh.load_pipeline_state(payload, fresh_opt)
    for (n, a), b in zip(pc.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(sum(opt.buffers, []), sum(fresh_opt.buffers, [])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(cls_token=False, pool_type="gap"), {}])
def test_token_sharding_at_one_rank_is_the_unfused_model(kw):
    """At a seq axis of 1 (no process group) a token-sharded ViT computes
    the ``force_unfused`` model bit for bit, forward and gradients, runs
    its K/V gathers once a block, and has the same state dict."""
    mesh = create_mesh(("data", "seq"), (1, 1))
    sharded = create_backbone("vit_ti_16", img_size=32, device="cpu",
                              token_sharding=TokenSharding(mesh), **kw)
    plain = create_backbone("vit_ti_16", img_size=32, device="cpu", **kw)
    assert sharded.state_dict().keys() == plain.state_dict().keys()
    x = torch.rand(8, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    from vision_toolbox_tpu_torch.parallel.mesh import GATHERS

    GATHERS.clear()
    a = sharded(x, train=True)
    assert GATHERS == {"kv": 12, "tokens": 1}
    b = plain(x, train=True, force_unfused=True)
    assert torch.equal(a, b)
    a.square().sum().backward()
    b.square().sum().backward()
    reduce_gradients(sharded, mesh)
    for (n, p), q in zip(sharded.named_parameters(), plain.parameters()):
        assert torch.equal(p.grad, q.grad), n


@pytest.fixture
def one_rank_world():
    """A one-rank gloo world (the card's phases 55-56 join a one-rank NCCL
    one): the meshes hold real process groups, so the relay's broadcast,
    the partial-gradient sums and the token gathers run as collectives."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _step_parts(**model_kw):
    """A seeded vit_ti_16 classifier at 32 px with SGD, the full recipe's
    step (CutMix⊕MixUp), a batch of 8 and the step's generator."""
    from vision_toolbox_tpu_torch.train import TrainState, make_train_step, sgd_with_param_groups

    gen = torch.Generator().manual_seed(0)
    model = ImageClassifier(create_backbone("vit_ti_16", img_size=32, device="cpu",
                                            generator=gen, **model_kw), 10, generator=gen)
    opt = sgd_with_param_groups(model, 0.1, momentum=0.9, weight_decay=2e-5)
    data = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, generator=data)
    labels = torch.randint(0, 10, (8,), generator=data)
    step = make_train_step(10, label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
    return TrainState(model, opt), step, images, labels, torch.Generator().manual_seed(2)


def _after_step(state, step, images, labels, g) -> tuple:
    loss = step(state, images, labels, g)["loss"]
    return loss, {n: (p.detach().clone(), p.grad.clone()) for n, p in
                  state.model.named_parameters()}


def test_world1_stage_path_is_the_sequential_step(one_rank_world):
    """Chip phase 55 at a small size: the seeded classifier's state dict
    taken to the pipeline layout and loaded into the pipelined classifier on
    a one-rank {"data": 1, "pipe": 1} world; one ``shard_train_step``
    without and with remat bit-equal in loss, gradients and parameters to
    the sequential step."""
    from vision_toolbox_tpu_torch.train import TrainState, sgd_with_param_groups, shard_train_step

    mesh = create_mesh(("data", "pipe"), (1, 1))
    assert mesh.groups is not None
    want = _after_step(*_step_parts())
    for remat in (False, True):
        state, step, images, labels, g = _step_parts()
        layout = pipeline.classifier_params_to_pipeline(state.model.state_dict())
        model = pipeline.make_classifier_pipeline_apply(state.model, mesh, remat=remat)
        opt = sgd_with_param_groups(model, 0.1, momentum=0.9, weight_decay=2e-5)
        model.load_pipeline_state({"model": layout, "optimizer": opt.state_dict()}, opt)
        loss, got = _after_step(TrainState(model, opt), shard_train_step(step, mesh), images,
                                labels, g)
        assert torch.equal(loss, want[0])
        assert got.keys() == want[1].keys()
        for n, (p, grad) in got.items():
            assert torch.equal(p, want[1][n][0]) and torch.equal(grad, want[1][n][1]), (remat, n)


def test_world1_token_sharding_is_the_unfused_step(one_rank_world):
    """Chip phase 56 at a small size: vit_ti_16 (cls token, T = 5) with
    ``token_sharding`` on a one-rank {"data": 1, "seq": 1} world through
    ``shard_train_step``, its K/V and token gathers real collectives, one
    step bit-equal to the ``force_unfused`` step."""
    from vision_toolbox_tpu_torch.parallel.mesh import GATHERS
    from vision_toolbox_tpu_torch.train import shard_train_step

    mesh = create_mesh(("data", "seq"), (1, 1))
    state, step, images, labels, g = _step_parts()
    backbone = state.model.backbone
    backbone.forward = lambda *a, **kw: type(backbone).forward(backbone, *a, force_unfused=True,
                                                               **kw)
    want = _after_step(state, step, images, labels, g)
    state, step, images, labels, g = _step_parts(token_sharding=TokenSharding(mesh))
    GATHERS.clear()
    loss, got = _after_step(state, shard_train_step(step, mesh), images, labels, g)
    assert GATHERS == {"kv": 12, "tokens": 1}
    assert torch.equal(loss, want[0])
    for n, (p, grad) in got.items():
        assert torch.equal(p, want[1][n][0]) and torch.equal(grad, want[1][n][1]), n


def test_dryrun_refuses_more_ranks_than_cards():
    """The dry run's launcher puts one rank on a card: more ranks than cards
    (none here) raise before any process starts."""
    from vision_toolbox_tpu_torch.parallel import dryrun

    with pytest.raises(ValueError, match="needs as many cards"):
        dryrun.main(["--nproc", "2"])
