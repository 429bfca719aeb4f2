"""Pipeline parallelism (vision_toolbox_tpu_torch/parallel/pipeline.py, the
trainer's pipe mode), sequence parallelism (ViT ``token_sharding``) and the
dry run (parallel/dryrun.py) on four gloo ranks.

One cluster of 4 processes (tests/torch_mp_pipeline_worker.py) runs every
leg in one launch, each on a 4-rank mesh of its own; while the ranks run,
this process computes the JAX package's pipeline forwards and
token-sharded models on its 8 CPU devices, JAX's stacked-state train step,
the port's one-process references and the world-1 trainer run. The ranks
and this process draw the same parameters with numpy
(``torch_mp_pipeline_worker.draw_state``), carried to the JAX package
through ``utils/jax_bridge.py``'s names and layouts, read backwards.

On the CPU the port's ViT/DeiT/CaiT/Mixer blocks run the K3/K4 twins,
which round their products to bf16, and a CPU bf16 product's rounding can
depend on its row count; so the pipelined runs are held against the same
model run in one process on the same microbatches (prologue on a rank's
rows, the blocks microbatch by microbatch, epilogue on the rank's rows:
outputs rtol/atol 1e-5 and gradients 1e-4 / 1e-5, the toy stack's bounds
of tests/test_pipeline.py), and against JAX's ``*_pipeline_forward`` with
the blocks on their module chain, which is what JAX's CPU path computes
(outputs rtol/atol 2e-4, tests/test_pipeline.py's). The trainer is held
against the world-1 trainer at JAX's own bound (rtol 2e-3 / atol 2e-4,
tests/test_trainer_pipeline.py), ``token_sharding`` against the unsharded
``force_unfused`` model and JAX's token-sharded model (outputs rtol/atol
2e-5, tests/test_pipeline.py:355; gradients rtol 2e-4 / atol 1e-5).
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_mp_pipeline_worker import (
    FAMILIES,
    PIPE_MESHES,
    SEQ_MESHES,
    SP_MODELS,
    TOY_CASES,
    ToyLayer,
    family_state,
    inputs,
    step_state,
    toy_stage,
    trainer_cfg,
    trainer_cfg_probe,
)

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from vision_toolbox_tpu import create_backbone as jax_backbone
from vision_toolbox_tpu.models.cait import CaiT as JaxCaiT
from vision_toolbox_tpu.models.mlp_mixer import MLPMixer as JaxMixer
from vision_toolbox_tpu.parallel import create_mesh as jax_mesh
from vision_toolbox_tpu.parallel.pipeline import (
    cait_pipeline_forward,
    mixer_pipeline_forward,
    pipeline_param_sharding,
    stack_block_params,
    unstack_block_params,
    vit_pipeline_forward,
    vit_pipeline_forward_stacked,
)
from vision_toolbox_tpu_torch.models.base import create_backbone
from vision_toolbox_tpu_torch.parallel.pipeline import classifier_params_from_pipeline
from vision_toolbox_tpu_torch.train import ImageClassifier
from vision_toolbox_tpu_torch.train.trainer import Trainer
from vision_toolbox_tpu_torch.utils.jax_bridge import _convert, flax_to_state_dict

NPROC = 4
HERE = os.path.dirname(os.path.abspath(__file__))
JAX_FAMILIES = {
    "vit_cls": lambda: jax_backbone("vit_ti_16", img_size=32),
    "vit_gap": lambda: jax_backbone("vit_ti_16", img_size=32, pool_type="gap", cls_token=False),
    "vit_mha": lambda: jax_backbone("vit_ti_16", img_size=32, pool_type="mha", cls_token=False),
    "deit": lambda: jax_backbone("deit_ti_16", img_size=32),
    "deit3": lambda: jax_backbone("deit3_ti_16", img_size=32),
    "cait": lambda: JaxCaiT(d_model=32, sa_depth=8, ca_depth=2, n_heads=2, patch_size=16,
                            img_size=32),
    "mixer": lambda: JaxMixer(n_layers=8, d_model=32, patch_size=16, img_size=32),
}
FAMILY_MESH = [(f, m) for f in FAMILIES for m in PIPE_MESHES]
SP_MESH = [(n, m) for n in SP_MODELS for m in SEQ_MESHES]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _jax_variables(module, state: dict, prefix: str = "") -> dict:
    """``module``'s variables holding the port state dict ``state``'s values
    (``prefix`` + the bridge's name of each JAX leaf; a kernel transposed
    back from the port's layout)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 32, 32, 3))))

    def leaf(path, s):
        keys = tuple(k.key for k in path)
        name, _ = _convert(keys, np.zeros(s.shape, np.float32))
        t = state[prefix + name].numpy()
        if keys[-1] == "kernel":
            t = t.T if t.ndim == 2 else t.transpose(2, 3, 1, 0)
        assert t.shape == s.shape, (name, t.shape, s.shape)
        return np.ascontiguousarray(t)

    return {"params": jax.tree_util.tree_map_with_path(leaf, shapes["params"])}


def _jax_stacked_step(variables: dict, head: dict, x: np.ndarray, y: np.ndarray):
    """tests/test_pipeline.py:296's step on these parameters and batch: the
    loss and the updated parameters as a port state dict."""
    mesh = jax_mesh(("data", "pipe"), (2, 4))
    vit = jax_backbone("vit_ti_16", img_size=32)
    stacked, rest = stack_block_params(jax.tree.map(jnp.asarray, variables["params"]))
    stacked = jax.device_put(stacked, pipeline_param_sharding(stacked, mesh))
    params = {"blocks": stacked, "rest": rest, "head": jax.tree.map(jnp.asarray, head)}

    def loss_fn(params, x, y):
        feats = vit_pipeline_forward_stacked(
            vit, params["blocks"], params["rest"], x, mesh=mesh, batch_axis="data",
            num_microbatches=8, train=True)
        logits = feats @ params["head"]["kernel"] + params["head"]["bias"]
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    @jax.jit
    def step(params, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        return loss, jax.tree.map(lambda p, g: p - 0.1 * g, params, grads)

    loss, new = step(params, jnp.asarray(x), jnp.asarray(y))
    new = _np(new)
    state = {f"backbone.{k}": v for k, v in
             flax_to_state_dict(unstack_block_params(new["blocks"], new["rest"])).items()}
    state["head.weight"] = torch.from_numpy(new["head"]["kernel"].T.copy())
    state["head.bias"] = torch.from_numpy(new["head"]["bias"].copy())
    return float(loss), {k: v.numpy() for k, v in state.items()}


def _microbatched(model, x: torch.Tensor, rows_per_mb: int, train: bool) -> torch.Tensor:
    """``model``'s forward in one process on the pipeline's microbatches:
    its prologue on ``x``, its blocks on each ``rows_per_mb`` rows, its
    epilogue on ``x``'s rows."""
    from vision_toolbox_tpu_torch.parallel.pipeline import _stack

    h = model._tokens(x)
    outs = []
    for mb in h.split(rows_per_mb):
        for block in _stack(model):
            mb = block(mb, train)
        outs.append(mb)
    return model._pool(torch.cat(outs), train)


def _family_reference(fam: str, state: dict, x: np.ndarray, weight: np.ndarray,
                      mesh_name: str) -> dict:
    """Features and gradients of the local mean of feat·weight, averaged
    over the data ranks, in one process on the pipeline's microbatches
    (2 rows each on both meshes: M = S)."""
    axes, sizes = PIPE_MESHES[mesh_name]
    dp = sizes[0] if "data" in axes else 1
    model = FAMILIES[fam]()
    model.load_state_dict(state, strict=True)
    outs = []
    for part in torch.from_numpy(x).split(len(x) // dp):
        feats = _microbatched(model, part, 2, True)
        ((feats * torch.from_numpy(weight)).sum() / len(feats) / dp).backward()
        outs.append(feats.detach().numpy())
    return dict(out=np.concatenate(outs),
                grads={f"backbone.{n}": p.grad.numpy() for n, p in model.named_parameters()
                       if p.grad is not None})


def _sp_reference(name: str, state: dict, x: np.ndarray, weight: np.ndarray) -> dict:
    model_name, kw = SP_MODELS[name]
    model = create_backbone(model_name, img_size=32, device="cpu", **kw)
    model.load_state_dict(state, strict=True)
    feats = model(torch.from_numpy(x), train=True, force_unfused=True)
    ((feats * torch.from_numpy(weight)).sum() / len(feats)).backward()
    return dict(out=feats.detach().numpy(), grads={n: p.grad.numpy() for n, p in
                                                   model.named_parameters()},
                state={k: tuple(v.shape) for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("torch_mp_pipeline")
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(NPROC)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mp_pipeline_worker.py"),
                               str(r), str(NPROC), port, str(out_dir)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(NPROC)]
    try:  # meanwhile: JAX's pipeline and token-sharded models, the references
        inp = inputs()
        x, feat_weight = inp["x"], inp["feat_weight"]
        families = {f: family_state(f) for f in FAMILIES}
        jax_models = {f: make() for f, make in JAX_FAMILIES.items()}
        variables = {f: _jax_variables(m, families[f]) for f, m in jax_models.items()}
        step = step_state()
        head = {"kernel": step["head.weight"].numpy().T.copy(), "bias": step["head.bias"].numpy()}
        pp_mesh = jax_mesh(("data", "pipe"), (2, 4))
        fwd = dict(cait=cait_pipeline_forward, mixer=mixer_pipeline_forward)
        jx = jnp.asarray(x)
        jax_out = {f: np.asarray(jax.jit(lambda v, x, f=f: fwd.get(f, vit_pipeline_forward)(
            jax_models[f], v, x, mesh=pp_mesh, batch_axis="data"))(variables[f], jx))
            for f in FAMILIES}
        sp_mesh = jax_mesh(("data", "seq"), (2, 4))
        jax_sp = {}
        for n, (model_name, kw) in SP_MODELS.items():
            m = jax_backbone(model_name, img_size=32,
                             token_sharding=NamedSharding(sp_mesh, P("data", "seq")), **kw)
            jax_sp[n] = np.asarray(jax.jit(m.apply)(variables[n], jx))
        jax_step = _jax_stacked_step(
            _jax_variables(jax_models["vit_cls"], step, "backbone."), head, inp["step_x"],
            inp["step_y"])
        reference = {(f, m): _family_reference(f, families[f], x, feat_weight[f], m)
                     for f, m in FAMILY_MESH}
        sp_reference = {n: _sp_reference(n, families[n], x, feat_weight[n]) for n in SP_MODELS}
        world1 = Trainer(trainer_cfg(str(out_dir / "world1"), None), device="cpu")
        world1.fit()
        world1_state = {k: v.numpy() for k, v in world1.model.state_dict().items()}
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (out_dir / f"rank{r}.log").read_text()[-4000:]
    records = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(NPROC)]
    return dict(records=records, toy=inp["toy"], jax_out=jax_out, jax_sp=jax_sp,
                jax_step=jax_step, reference=reference, sp_reference=sp_reference,
                world1_state=world1_state, out_dir=str(out_dir), x=x, families=families)


def test_cluster_is_four_gloo_ranks(cluster):
    assert [r["rank"] for r in cluster["records"]] == list(range(NPROC))
    assert all(r["world"] == NPROC for r in cluster["records"])


# ------------------------------------------------------------- the schedule


@pytest.mark.parametrize("case", list(TOY_CASES))
def test_toy_schedule_matches_sequential(cluster, case):
    """tests/test_pipeline.py's toy stack: every rank's outputs equal the
    sequential run's rows; each rank's layers' gradients (summed over the
    data axis) and stage 0's input gradient equal the sequential ones; each
    rank calls its stage M·v times (the bubble skip; once at S = 1)."""
    toy = cluster["toy"]
    layers = [ToyLayer(torch.from_numpy(w), torch.from_numpy(b))
              for w, b in zip(toy["w"], toy["b"])]
    x = torch.from_numpy(toy["x"]).requires_grad_()
    y = toy_stage(layers, x)
    (y * torch.from_numpy(toy["weight"])).sum().backward()
    want = {f"{i}.{k}": getattr(layer, k).grad.numpy()
            for i, layer in enumerate(layers) for k in ("w", "b")}
    axes, sizes, M, v = TOY_CASES[case]
    S = dict(zip(axes, sizes))["pipe"]
    held = set()
    for rec in (r[f"toy/{case}"] for r in cluster["records"]):
        rows = slice(*rec["rows"])
        _close(rec["out"], y.detach().numpy()[rows], 1e-5, 1e-5, case)
        for k, g in rec["grads"].items():
            _close(g, want[k], 1e-4, 1e-5, f"{case} {k}")
        held |= set(rec["grads"])
        if rec["x_grad"] is not None:
            _close(rec["x_grad"], x.grad.numpy()[rows], 1e-4, 1e-5, case)
        assert len(rec["calls"]) == (M * v if S > 1 else 1), rec["calls"]
    assert held == set(want)


# ----------------------------------------------------------- family forwards


@pytest.mark.parametrize("fam,mesh", FAMILY_MESH)
def test_family_pipeline_matches_one_process(cluster, fam, mesh):
    """Each rank's features equal the one-process run's rows on the same
    microbatches, and its blocks' and the rest's whole gradients equal the
    one-process ones; every block is held by exactly one pipe rank."""
    ref = cluster["reference"][(fam, mesh)]
    held = []
    for rec in (r[f"family/{fam}/{mesh}"] for r in cluster["records"]):
        run = rec["remat0"]
        _close(run["out"], ref["out"][slice(*rec["rows"])], 1e-5, 1e-5, fam)
        for k, g in run["grads"].items():
            if k.startswith("head."):
                continue
            _close(g, ref["grads"][k], 1e-4, 1e-5, f"{fam} {mesh} {k}")
        held += [tuple(rec["owned"])]
    owned = {i for o in held for i in o}
    assert owned == set(range(12 if fam.startswith(("vit", "deit")) else 8))


@pytest.mark.parametrize("fam,mesh", FAMILY_MESH)
def test_family_pipeline_matches_jax(cluster, fam, mesh):
    """The pipelined forward with the blocks on their module chain against
    JAX's ``*_pipeline_forward`` on the same parameters (a {"data": 2,
    "pipe": 4} mesh of 8 CPU devices)."""
    want = cluster["jax_out"][fam]
    for rec in (r[f"family/{fam}/{mesh}"] for r in cluster["records"]):
        _close(rec["unfused"], want[slice(*rec["rows"])], 2e-4, 2e-4, fam)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_remat_equals_no_remat(cluster, fam):
    """remat=True is a pure memory/compute trade: the same features and
    gradients ({"data": 2, "pipe": 2})."""
    for rec in (r[f"family/{fam}/data2_pipe2"] for r in cluster["records"]):
        a, b = rec["remat0"], rec["remat1"]
        _close(b["out"], a["out"], 0, 0, fam)
        assert a["grads"].keys() == b["grads"].keys()
        for k in a["grads"]:
            _close(b["grads"][k], a["grads"][k], 1e-6, 1e-9, f"{fam} {k}")


@pytest.mark.parametrize("fam,mesh", FAMILY_MESH)
def test_rest_is_bit_equal_across_pipe_ranks(cluster, fam, mesh):
    """After one SGD step on the summed gradients, the replicated parameters
    (patch embedding, PE, tokens, norms, pooler, head) are bit-equal on
    every rank."""
    recs = [r[f"family/{fam}/{mesh}"]["rest_after_step"] for r in cluster["records"]]
    for rec in recs[1:]:
        assert rec.keys() == recs[0].keys()
        for k, v in rec.items():
            assert np.array_equal(v, recs[0][k]), (fam, mesh, k)


def test_stacked_state_train_step_matches_jax(cluster):
    """tests/test_pipeline.py:296's step (vit_ti_16, 8 microbatches of the
    batch of 16 over {"data": 2, ...}, cross entropy, SGD at 0.1) from the
    same parameters and batch: the loss and every updated parameter, taken
    back to the standard layout, equal JAX's; every rank holds the same."""
    loss, want = cluster["jax_step"]
    for rec in (r["stacked_step"] for r in cluster["records"]):
        assert abs(rec["loss"] - loss) <= 1e-5 * abs(loss), (rec["loss"], loss)
        assert rec["params"].keys() == want.keys()
        for k, v in want.items():
            _close(rec["params"][k], v, 2e-4, 1e-5, k)


# ------------------------------------------------------------------ trainer


@pytest.mark.parametrize("leg,interleave", [("pp", 1), ("ppi", 3)])
def test_pipe_trainer_matches_world1(cluster, leg, interleave):
    """10 steps on {"data": 2, "pipe": 2} (M = 8; interleave 3 caps M at
    S = 2) against the world-1 trainer: the parameters, taken back to the
    standard layout, at rtol 2e-3 / atol 2e-4 (JAX's own bound)."""
    want = cluster["world1_state"]
    for rec in (r[f"trainer/{leg}"] for r in cluster["records"]):
        assert rec["M"] == (8 if interleave == 1 else 2)
        got = classifier_params_from_pipeline(
            {k: torch.from_numpy(v) for k, v in rec["whole"]["model"].items()},
            stages=2, interleave=interleave)
        assert got.keys() == want.keys()
        for k, v in want.items():
            _close(got[k].numpy(), v, 2e-3, 2e-4, f"{leg} {k}")


def test_pipe_checkpoint_resumes_bit_exactly(cluster):
    """A pipe trainer resumed from the run's step-10 checkpoint holds the
    run's parameters and momentum buffers bit for bit, on every rank."""
    for rec in cluster["records"]:
        got, want = rec["trainer/resumed"], rec["trainer/pp"]["whole"]
        assert got["step"] == 10
        for part in ("model", "buffers"):
            assert got["whole"][part].keys() == want[part].keys() and want[part]
            for k, v in want[part].items():
                assert np.array_equal(got["whole"][part][k], v), (part, k)


def test_pipe_checkpoint_converts_to_the_sequential_model(cluster):
    """The checkpoint's model, taken to the standard layout, loads into the
    sequential classifier, whose logits on the pipeline's microbatches
    equal the pipe trainer's within 2e-4."""
    path = os.path.join(cluster["out_dir"], "pp_rank0", "checkpoints", "step_10", "state.pt")
    payload = torch.load(path, weights_only=True)
    assert any(k.startswith("backbone_stacked.") for k in payload["model"])
    model = ImageClassifier(create_backbone("vit_ti_16", img_size=32, device="cpu"), 10)
    model.load_state_dict(classifier_params_from_pipeline(payload["model"], stages=2))
    x = torch.from_numpy(trainer_cfg_probe())
    with torch.no_grad():  # 16 rows a rank over M = 8 microbatches: 2 rows each
        logits = model.head(_microbatched(model.backbone, x, 2, False)).numpy()
    for rec in cluster["records"]:
        _close(rec["trainer/pp"]["logits"], logits, 2e-4, 2e-4)


def test_pipe_trainer_rejections(cluster):
    want = {"family": "stacked-transformer", "dropout": "rng streams",
            "fsdp": "data parallelism only", "microbatch": "microbatch",
            "data_axis": "needs a 'data' axis"}
    for rec in cluster["records"]:
        got = rec["trainer/refusals"]
        for case, words in want.items():
            assert got[case] is not None and words in got[case], (case, got[case])


# --------------------------------------------------------- token_sharding


@pytest.mark.parametrize("name,mesh", SP_MESH)
def test_token_sharding_matches_unsharded_and_jax(cluster, name, mesh):
    """Each rank's features equal the unsharded ``force_unfused`` model's
    rows and JAX's token-sharded model's at rtol/atol 2e-5; its whole
    gradients (seq sums, data mean) equal the one-process ones at rtol 2e-4
    / atol 1e-5; the state dict is the unsharded model's; one forward
    all-gathers K and V once a block, the tokens once."""
    ref = cluster["sp_reference"][name]
    for rec in (r[f"sp/{name}/{mesh}"] for r in cluster["records"]):
        rows = slice(*rec["rows"])
        _close(rec["out"], ref["out"][rows], 2e-5, 2e-5, name)
        _close(rec["out"], cluster["jax_sp"][name][rows], 2e-5, 2e-5, name)
        assert rec["grads"].keys() == ref["grads"].keys()
        for k, g in rec["grads"].items():
            _close(g, ref["grads"][k], 2e-4, 1e-5, f"{name} {mesh} {k}")
        assert rec["state"] == ref["state"]
        assert rec["gathers"] == {"kv": 12, "tokens": 1}


def test_token_sharding_refuses_dropout_in_training(cluster):
    for rec in cluster["records"]:
        assert rec["sp/dropout"] is not None and "dropout" in rec["sp/dropout"]


def test_pair_test_counts_the_global_batch(cluster):
    """vit_b_16's 12 heads at a global batch of 8 over {"data": 2}: inside
    the data axis the rule counts 96 pairs and runs K2 in each of the two
    blocks, as the one-process model at batch 8 does (and computes its
    rows); outside it the rank's 48 pairs take ``dense_attention``."""
    for rec in (r["pair_test"] for r in cluster["records"]):
        assert rec["global"]["k2_calls"] == [4, 4]
        assert rec["one_process"]["k2_calls"] == [8, 8]
        assert rec["local"]["k2_calls"] == []
        _close(rec["global"]["out"], rec["one_process"]["out"], 1e-6, 1e-6)


def test_dryrun_legs(cluster):
    """The dry run's four legs (``parallel/dryrun.run_legs``) at 4 ranks:
    finite losses, equal on every rank; the pipeline leg's blocks held d,
    d+4, d+8 (4 stages x 3 chunks); 12 K/V all-gathers in the sp step."""
    legs = [{r["leg"]: r for r in rec["dryrun"]} for rec in cluster["records"]]
    for rank, leg in enumerate(legs):
        assert list(leg) == ["dp_tp", "fsdp", "pp", "sp"]
        assert all(math.isfinite(r["loss"]) and r["loss"] == legs[0][k]["loss"]
                   for k, r in leg.items())
        assert leg["dp_tp"]["mesh"] == {"data": 2, "model": 2}
        assert leg["pp"]["owned"] == [rank, rank + 4, rank + 8]
        assert leg["sp"]["kv_gathers"] == 12
