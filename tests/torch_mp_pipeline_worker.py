"""One rank of the pipeline and sequence-parallel test cluster
(tests/test_torch_mp_pipeline.py).

    python tests/torch_mp_pipeline_worker.py <rank> <world> <port> <out_dir>

Joins a gloo world through ``parallel/mesh.init_process_group`` (env://)
and runs every leg in one launch, each on a 4-rank mesh
(``{"pipe": 4}``, ``{"data": 2, "pipe": 2}``, ``{"seq": 4}``,
``{"data": 2, "seq": 2}``, ``{"data": 2, "model": 2}``; one set of
process groups per mesh), writing its records to
``<out_dir>/rank<rank>.pt``. Imports torch and the port only. The inputs
and the parameters are drawn here with numpy from fixed seeds
(``draw_state``), so that the test process, which makes the same draws and
carries them to the JAX package, needs to send the ranks nothing.
"""

from __future__ import annotations

import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_threads  # noqa: E402,F401  (one torch CPU thread per test process)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch import nn  # noqa: E402

from vision_toolbox_tpu_torch.models.base import create_backbone  # noqa: E402
from vision_toolbox_tpu_torch.models.cait import CaiT  # noqa: E402
from vision_toolbox_tpu_torch.models.mlp_mixer import MLPMixer  # noqa: E402
from vision_toolbox_tpu_torch.ops import short_attention  # noqa: E402
from vision_toolbox_tpu_torch.parallel import dryrun  # noqa: E402
from vision_toolbox_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from vision_toolbox_tpu_torch.parallel.mesh import (  # noqa: E402
    GATHERS,
    TokenSharding,
    batch_rows,
    data_parallel,
    init_process_group,
)
from vision_toolbox_tpu_torch.parallel.pipeline import (  # noqa: E402
    PipelineClassifier,
    classifier_params_from_pipeline,
    pipeline_apply,
    pipeline_forward_stacked,
)
from vision_toolbox_tpu_torch.parallel.sharding import reduce_gradients  # noqa: E402
from vision_toolbox_tpu_torch.train import ImageClassifier, config, make_optimizer  # noqa: E402
from vision_toolbox_tpu_torch.train.classifier import cross_entropy  # noqa: E402
from vision_toolbox_tpu_torch.train.trainer import Trainer  # noqa: E402

# the pipelined families at 32 px (tests/test_pipeline.py's, with deit_ti_16)
FAMILIES = {
    "vit_cls": lambda: create_backbone("vit_ti_16", img_size=32, device="cpu"),
    "vit_gap": lambda: create_backbone("vit_ti_16", img_size=32, pool_type="gap",
                                       cls_token=False, device="cpu"),
    "vit_mha": lambda: create_backbone("vit_ti_16", img_size=32, pool_type="mha",
                                       cls_token=False, device="cpu"),
    "deit": lambda: create_backbone("deit_ti_16", img_size=32, device="cpu"),
    "deit3": lambda: create_backbone("deit3_ti_16", img_size=32, device="cpu"),
    "cait": lambda: CaiT(d_model=32, sa_depth=8, ca_depth=2, n_heads=2, patch_size=16,
                         img_size=32, device="cpu"),
    "mixer": lambda: MLPMixer(n_layers=8, d_model=32, patch_size=16, img_size=32,
                              device="cpu"),
}
# token_sharding's cases (tests/test_pipeline.py:355): T = 4, 5 (padded), 6 (padded)
SP_MODELS = {
    "vit_gap": ("vit_ti_16", dict(cls_token=False, pool_type="gap")),
    "vit_cls": ("vit_ti_16", {}),
    "deit": ("deit_ti_16", {}),
}
PIPE_MESHES = {"pipe4": (("pipe",), (4,)), "data2_pipe2": (("data", "pipe"), (2, 2))}
SEQ_MESHES = {"seq4": (("seq",), (4,)), "data2_seq2": (("data", "seq"), (2, 2))}
TOY_CASES = {  # name: (axes, sizes, M, interleave); the batch axis is "data" where there is one
    "pipe4_m4": (("pipe",), (4,), 4, 1),
    "pipe4_m12": (("pipe",), (4,), 12, 1),
    "data2_pipe2_m6": (("data", "pipe"), (2, 2), 6, 1),
    "pipe1": (("data", "pipe"), (4, 1), 2, 1),  # M is then unused, as in JAX
    "pipe4_v2_m4": (("pipe",), (4,), 4, 2),
    "pipe4_v2_m2": (("pipe",), (4,), 2, 2),
    "data2_pipe2_v4_m2": (("data", "pipe"), (2, 2), 2, 4),
}


_MESHES: dict = {}


def create_mesh(axes, sizes):
    """The mesh of (axes, sizes), its process groups made once (every rank
    asks for the meshes in one order)."""
    key = (tuple(axes), tuple(sizes))
    if key not in _MESHES:
        _MESHES[key] = port_mesh.create_mesh(axes, sizes)
    return _MESHES[key]


def draw_state(model: nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """numpy draws for ``model``'s state dict, as tests/torch_convnets.py
    draws a JAX tree: weights of two or more dims N(0, 2/fan-in), norm
    scales 0.5 + U(0, 1), the rest 0.1·N(0, 1) (tokens and PE included, so
    that no LayerNorm sees an all-zero row)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        parts = name.split(".")
        if parts[-1] == "weight" and len(shape) >= 2:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif parts[-1] == "weight" and "norm" in parts[-2]:
            a = 0.5 + rng.random(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def inputs() -> dict:
    """The legs' inputs: tests/test_pipeline.py's toy stack (L = 8, D = 16,
    its batch of 24), the images of 8 at 32 px, the feature weights, and
    the stacked step's batch of 16 and labels."""
    rng = np.random.default_rng(0)
    f32 = lambda a: np.asarray(a, np.float32)
    toy = dict(w=f32(rng.standard_normal((8, 16, 16)) * 16**-0.5),
               b=f32(0.1 * rng.standard_normal((8, 16))), x=f32(rng.standard_normal((24, 16))),
               weight=f32(np.cos(np.arange(16))))
    return dict(toy=toy, x=f32(rng.random((8, 32, 32, 3))),
                feat_weight={f: f32(rng.standard_normal(192 if f[:3] in ("vit", "dei") else 32))
                             for f in FAMILIES},
                step_x=f32(rng.random((16, 32, 32, 3))), step_y=rng.integers(0, 10, 16))


def family_state(fam: str) -> dict[str, torch.Tensor]:
    return draw_state(FAMILIES[fam](), list(FAMILIES).index(fam))


def step_state() -> dict[str, torch.Tensor]:
    """The stacked step's classifier: vit_ti_16 at 32 px, 10 classes."""
    return draw_state(ImageClassifier(create_backbone("vit_ti_16", img_size=32, device="cpu"),
                                      10), 100)


class ToyLayer(nn.Module):
    """One layer of tests/test_pipeline.py's toy stack: tanh(h·w + b)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w, self.b = nn.Parameter(w.clone()), nn.Parameter(b.clone())


def toy_stage(layers, h):
    for layer in layers:
        h = torch.tanh(h @ layer.w + layer.b)
    return h


def _grads(model: nn.Module) -> dict:
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters() if p.grad is not None}


def toy_legs(inp: dict, rec: dict) -> None:
    """The toy stack through ``pipeline_apply``: this rank's outputs, its
    layers' gradients summed over the data axis, its input's gradient, and
    the stage function's calls."""
    W, b, x, w = (torch.from_numpy(inp["toy"][k]) for k in ("w", "b", "x", "weight"))
    for name, (axes, sizes, M, v) in TOY_CASES.items():
        mesh = create_mesh(axes, sizes)
        layers = [ToyLayer(W[i], b[i]) for i in range(len(W))]
        rows = batch_rows(mesh, len(x))
        xr = x[rows].clone().requires_grad_()
        calls = []

        def stage(chunk, h):
            calls.append(len(chunk))
            return toy_stage(chunk, h)

        y = pipeline_apply(stage, layers, xr, mesh=mesh, batch_axis="data" if "data" in axes
                           else None, num_microbatches=M, interleave=v)
        (y * w).sum().backward()
        model = nn.ModuleList(layers)
        if mesh.group("data") is not None:
            for p in model.parameters():
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=mesh.group("data"))
        rec[f"toy/{name}"] = dict(rows=(rows.start, rows.stop), out=y.detach().numpy(),
                                  grads=_grads(model), calls=calls,
                                  x_grad=None if xr.grad is None else xr.grad.numpy())


def _load(model: nn.Module, state: dict) -> nn.Module:
    model.load_state_dict(state, strict=True)
    return model


def family_legs(inp: dict, rec: dict) -> None:
    """Each family's pipelined forward on {"pipe": 4} and {"data": 2,
    "pipe": 2}: features and whole gradients (pipe sums and the data mean,
    ``reduce_gradients``) of the local mean of ``feat·weight`` in training
    (and with remat on {"data": 2, "pipe": 2}), the blocks' module chain in
    eval for the JAX comparison, and the rest's parameters after one SGD
    step."""
    x = torch.from_numpy(inp["x"])
    for fam, make in FAMILIES.items():
        state = family_state(fam)
        weight = torch.from_numpy(inp["feat_weight"][fam])
        for mesh_name, (axes, sizes) in PIPE_MESHES.items():
            mesh = create_mesh(axes, sizes)
            rows = batch_rows(mesh, len(x))
            batch_axis = "data" if "data" in axes else None
            out = {}
            for remat in (False, True) if mesh_name == "data2_pipe2" else (False,):
                clf = ImageClassifier(_load(make(), state), 10)
                pc = PipelineClassifier(clf, mesh, batch_axis=batch_axis, remat=remat)
                if not remat:
                    with torch.no_grad():
                        out["unfused"] = pipeline_forward_stacked(
                            pc.backbone, getattr(pc.backbone, pc.prefix[:-1]), x[rows],
                            mesh=mesh, batch_axis=batch_axis, force_unfused=True).numpy()
                feats = pipeline_forward_stacked(
                    pc.backbone, getattr(pc.backbone, pc.prefix[:-1]), x[rows], mesh=mesh,
                    batch_axis=batch_axis, train=True, remat=remat)
                ((feats * weight).sum() / len(feats)).backward()
                reduce_gradients(pc, mesh)
                out[f"remat{int(remat)}"] = dict(out=feats.detach().numpy(), grads=_grads(pc))
            with torch.no_grad():  # one SGD step: the replicated rest stays bit-equal
                for p in pc.parameters():
                    p -= 0.1 * p.grad
            blocks = set(pc._block_names())
            out["rest_after_step"] = {n: p.detach().numpy().copy()
                                      for n, p in pc.named_parameters() if n not in blocks}
            out["rows"], out["owned"] = (rows.start, rows.stop), pc.owned
            rec[f"family/{fam}/{mesh_name}"] = out


def stacked_step_leg(inp: dict, rec: dict) -> None:
    """tests/test_pipeline.py's ``test_vit_pipeline_train_step_stacked_state``
    step on {"data": 2, "pipe": 2}: 8 microbatches of the batch of 16, cross
    entropy, SGD at 0.1 on every parameter; the loss and the whole updated
    parameters in the standard layout (the blocks on the module chain, as
    JAX's CPU step runs them)."""
    mesh = create_mesh(("data", "pipe"), (2, 2))
    clf = ImageClassifier(create_backbone("vit_ti_16", img_size=32, device="cpu"), 10)
    clf.load_state_dict(step_state(), strict=True)
    pc = PipelineClassifier(clf, mesh, num_microbatches=8)
    rows = batch_rows(mesh, 16)
    x, y = torch.from_numpy(inp["step_x"])[rows], torch.from_numpy(inp["step_y"])[rows].long()
    logits = pipeline_forward_stacked(pc.backbone, pc.backbone.blocks, x, mesh=mesh,
                                      batch_axis="data", num_microbatches=8, train=True,
                                      head=lambda f: pc.head(f).float(), force_unfused=True)
    loss = cross_entropy(logits, y)
    loss.backward()
    reduce_gradients(pc, mesh)
    sgd = make_optimizer("sgd", pc, 0.1, momentum=0.0, weight_decay=0.0)
    sgd.step()
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=mesh.group("data"))
    whole = pc.pipeline_state(sgd)["model"]
    rec["stacked_step"] = dict(loss=float(loss) / 2, params={
        k: v.numpy() for k, v in classifier_params_from_pipeline(whole).items()})


def trainer_cfg(run_dir: str, mesh_shape: dict | None, **runtime) -> config.Config:
    """tests/test_trainer_pipeline.py's config."""
    cfg = config.Config()
    cfg.model.backbone, cfg.model.backbone_kwargs = "vit_ti_16", {"img_size": 32}
    cfg.model.num_classes, cfg.model.bf16 = 10, False
    cfg.data.synthetic, cfg.data.batch_size = True, 16
    cfg.data.train_crop_size = cfg.data.val_crop_size = 32
    cfg.data.trivial_augment, cfg.data.random_erasing_p = False, 0.0
    cfg.train.mixup_alpha = cfg.train.cutmix_alpha = 0.0
    cfg.train.epochs, cfg.train.warmup_epochs = 1, 1
    cfg.runtime.out_dir, cfg.runtime.log_every = run_dir, 5
    cfg.runtime.mesh_shape = mesh_shape
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    return cfg


def _whole(trainer) -> dict:
    """The trainer's model and optimizer in the pipeline layout (every rank
    calls it)."""
    out = trainer.model.pipeline_state(trainer.state.optimizer)
    return dict(model={k: v.numpy() for k, v in out["model"].items()},
                buffers={k: v.numpy() for k, v in (out["optimizer"]["buffers"] or {}).items()})


def trainer_legs(out_dir: str, rank: int, rec: dict) -> None:
    """The trainer on {"data": 2, "pipe": 2}: 10 steps, then the same with
    interleave 3, a resume from the first run's checkpoint, the pipeline
    logits of the first run at the configured batch, and the refusals."""
    mesh = {"data": 2, "pipe": 2}
    run = lambda name: os.path.join(out_dir, f"{name}_rank{rank}")
    tr = Trainer(trainer_cfg(run("pp"), mesh), device="cpu")
    tr.fit()
    rec["trainer/pp"] = dict(M=tr.pp_microbatches, whole=_whole(tr), dir=run("pp"),
                             metrics=os.path.join(run("pp"), "metrics.jsonl"))
    x = torch.from_numpy(trainer_cfg_probe())
    with torch.no_grad():
        rec["trainer/pp"]["logits"] = tr.model(x, train=False).numpy()
    tri = Trainer(trainer_cfg(run("ppi"), mesh, pipeline_interleave=3), device="cpu")
    tri.fit()
    rec["trainer/ppi"] = dict(M=tri.pp_microbatches, whole=_whole(tri))
    ckpt = os.path.join(out_dir, "pp_rank0", "checkpoints", "step_10")
    res = Trainer(trainer_cfg(run("res"), mesh, resume=ckpt), device="cpu")
    rec["trainer/resumed"] = dict(step=res.state.step, whole=_whole(res))

    refusals = {}
    for case, cfg in (
            ("family", _refused(run("a"), mesh, backbone="darknet19")),
            ("dropout", _refused(run("b"), mesh, drop_out=0.1)),
            ("fsdp", _refused(run("c"), mesh, param_sharding="fsdp")),
            ("microbatch", _refused(run("d"), mesh, batch_size=6)),
            ("data_axis", _refused(run("e"), {"pipe": 4}))):
        try:
            Trainer(cfg, device="cpu")
            refusals[case] = None
        except ValueError as e:
            refusals[case] = str(e)
    rec["trainer/refusals"] = refusals


def trainer_cfg_probe():
    import numpy as np

    return np.random.default_rng(5).random((16, 32, 32, 3), np.float32)


def _refused(run_dir: str, mesh_shape: dict, backbone: str | None = None,
             drop_out: float | None = None, param_sharding: str | None = None,
             batch_size: int | None = None) -> config.Config:
    cfg = trainer_cfg(run_dir, mesh_shape)
    if backbone:
        cfg.model.backbone, cfg.model.backbone_kwargs = backbone, {}
    cfg.model.drop_out = drop_out
    cfg.runtime.param_sharding = param_sharding or "replicated"
    cfg.data.batch_size = batch_size or cfg.data.batch_size
    return cfg


def sp_legs(inp: dict, rec: dict) -> None:
    """token_sharding on {"seq": 4} and {"data": 2, "seq": 2}: this rank's
    features and whole gradients (``reduce_gradients``: the seq sums and
    the data mean) of the local mean of ``feat·weight`` in training, the state dict's
    keys and shapes, the K/V all-gathers of one forward; and dropout's
    refusal."""
    x = torch.from_numpy(inp["x"])
    for name, (model_name, kw) in SP_MODELS.items():
        state = family_state(name)
        weight = torch.from_numpy(inp["feat_weight"][name])
        for mesh_name, (axes, sizes) in SEQ_MESHES.items():
            mesh = create_mesh(axes, sizes)
            ts = TokenSharding(mesh, batch="data" if "data" in axes else None)
            model = _load(create_backbone(model_name, img_size=32, device="cpu",
                                          token_sharding=ts, **kw), state)
            rows = batch_rows(mesh, len(x))
            GATHERS.clear()
            with data_parallel(mesh):
                feats = model(x[rows], train=True)
                ((feats * weight).sum() / len(feats)).backward()
            reduce_gradients(model, mesh)
            rec[f"sp/{name}/{mesh_name}"] = dict(
                rows=(rows.start, rows.stop), out=feats.detach().numpy(), grads=_grads(model),
                gathers=dict(GATHERS),
                state={k: tuple(v.shape) for k, v in model.state_dict().items()})
    mesh = create_mesh(("seq",), (4,))
    model = create_backbone("vit_ti_16", img_size=32, device="cpu", dropout=0.1,
                            token_sharding=TokenSharding(mesh, batch=None))
    try:
        model(x[:2], train=True, generator=torch.Generator().manual_seed(0))
        rec["sp/dropout"] = None
    except ValueError as e:
        rec["sp/dropout"] = str(e)


def pair_test_leg(inp: dict, rec: dict) -> None:
    """K2's pair test under a data axis of 2 ({"data": 2, "model": 2}):
    vit_b_16's width and heads (depth cut to 2) with dropout 0.1, served at
    a global batch of 8 (96 pairs; 48 a rank): inside ``data_parallel`` the
    rule counts the global batch and K2 runs, outside it the local one and
    ``dense_attention`` runs."""
    from vision_toolbox_tpu_torch.models.vit import ViT

    mesh = create_mesh(("data", "model"), (2, 2))
    model = ViT(768, 2, 12, 16, 32, dropout=0.1, device="cpu",
                generator=torch.Generator().manual_seed(0)).eval()
    rows = batch_rows(mesh, 8)
    x = torch.from_numpy(inp["x"])
    plain, calls = short_attention.short_attention_plain, []

    def counted(*args):
        calls.append(args[0].shape[0])
        return plain(*args)

    short_attention.short_attention_plain = counted
    out = {}
    try:
        with torch.no_grad():
            for where in ("global", "local"):
                calls.clear()
                if where == "global":
                    with data_parallel(mesh):
                        y = model(x[rows])
                else:
                    y = model(x[rows])
                out[where] = dict(k2_calls=list(calls), out=y.numpy())
            calls.clear()
            out["one_process"] = dict(out=model(x).numpy()[rows], k2_calls=list(calls))
    finally:
        short_attention.short_attention_plain = plain
    rec["pair_test"] = out


def main() -> None:
    rank, world, port, out_dir = sys.argv[1:5]
    os.environ.update(RANK=rank, WORLD_SIZE=world, MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    rank = int(rank)
    rec: dict = {"rank": rank}
    init_process_group("cpu")
    inp = inputs()
    rec["world"] = dist.get_world_size()
    for leg in (lambda: toy_legs(inp, rec), lambda: family_legs(inp, rec),
                lambda: stacked_step_leg(inp, rec), lambda: sp_legs(inp, rec),
                lambda: pair_test_leg(inp, rec), lambda: trainer_legs(out_dir, rank, rec)):
        leg()
    rec["dryrun"] = dryrun.run_legs("cpu")
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
