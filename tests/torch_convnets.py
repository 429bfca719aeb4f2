"""Shared parts of the CPU tests that hold the port's MBConv nets, ResNets,
RegNets and necks against the JAX package (tests/test_torch_efficientnet.py,
test_torch_resnet.py, test_torch_necks.py).

- ``random_variables``: the variables are drawn with numpy on the shapes of
  the JAX init (``jax.eval_shape``; a jitted flax init of these models costs
  10 s and more to compile, its trace a second or two) and carried into the
  port through ``utils/jax_bridge.py``: kernels N(0, 2/fan-in), biases and
  BN means 0.1·N(0, 1), BN scales and variances 0.5 + U(0, 1), BiFPN's
  fusion weights 0.3 + U(0, 1), so that eval mode reads real statistics
  and every branch carries signal.
- ``hold_module``: a module (a block, or a model's feature maps) in f32,
  eval and train outputs, running statistics and gradients.
- ``DropPathMasks``: drop-path keep masks fed to both sides in draw order,
  as tests/test_torch_patchconvnet.py feeds them: a jitted JAX step draws
  when traced, the port every step, so both take mask i mod n.
- ``run_steps`` / ``check_steps``: the classifier train step (CutMix⊕MixUp,
  label smoothing 0.1, SGD 0.9 with three-group weight decay 2e-5) on both
  sides from the same variables and draws. f32: loss, parameters, BN
  statistics and momentum buffers rtol = atol = 1e-4 (f32 summation order
  of convolutions and batch statistics through a chain of BNs). bf16: the
  loss within rel 1e-2 of either JAX step, or within twice the JAX
  package's own bf16 error against its f32 step; the parameters, the BN
  statistics and the momentum buffers, each kind taken together, rel L2 ≤
  1e-2 from the JAX bf16 step or within twice that kind's own bf16 error
  (two independent bf16 roundings of one f32 computation differ by about
  √2 times either's error; BN backwards cancel in bf16,
  tests/test_torch_train_step.py); and, tensor by tensor, the port's bf16
  error against the JAX f32 step is at most 1.5× the JAX bf16 step's in
  the median (the port's bf16 path no less exact than JAX's). Single
  tensors are not bounded one by one: at batch 4 an SE's squeeze gradient
  sums four noisy terms, and one of the narrow EfficientNet's read 20% from
  the JAX bf16 step where JAX's own error was 5% (median ratio over its
  tensors 0.91).

The f32 bounds hold where no pre-activation lies within f32 noise of a
ReLU kink or a max-pool tie: there the two packages may take different
sides, and that element's whole gradient moves. Measured on a narrow
RegNetY step at 64 px: one stem element of 65,536 read +1.9e-6 in JAX and
0 in the port (the train-mode BN's fast variance over [0, 1] images),
which moved its channel's BN-bias gradient by 14% (the port's value is the
finite difference of its own float64 forward). The step cases run at
shapes where no element sits that close; the bf16 bounds cover the rest.
"""

import math

import numpy as np
import optax
import torch
from torch_draws import step_draws

import jax
import jax.numpy as jnp

from vision_toolbox_tpu.train import ImageClassifier as JaxClassifier
from vision_toolbox_tpu.train import TrainState as JaxState
from vision_toolbox_tpu.train import make_train_step as jax_train_step
from vision_toolbox_tpu.train import sgd_with_param_groups as jax_sgd
from vision_toolbox_tpu_torch.nn.layers import StochasticDepth
from vision_toolbox_tpu_torch.train import (
    ImageClassifier,
    TrainState,
    make_train_step,
    sgd_with_param_groups,
)
from vision_toolbox_tpu_torch.utils.jax_bridge import flax_to_state_dict

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CLASSES = 10
RECIPE = dict(label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0)
LR = 0.1
SEED = 7  # step 0 draws MixUp, step 1 CutMix
REL_L2 = 1e-2
MEDIAN_RATIO = 1.5
STEP_TOL = 1e-4
TOL = 1e-5
GRAD_TOL = 1e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel_l2(got, want, ref=None) -> float:
    """‖got − want‖ / ‖ref‖, ref defaulting to want."""
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    ref = want if ref is None else np.asarray(ref, np.float32).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(ref), 1e-12))


def random_variables(shapes, seed: int = 0) -> dict:
    """numpy leaves for a tree of ``ShapeDtypeStruct``s (a JAX init's
    shapes), drawn as the module docstring sets out."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        if leaf == "kernel":
            a = rng.standard_normal(s.shape) * math.sqrt(2.0 / math.prod(s.shape[:-1]))
        elif leaf in ("scale", "var"):
            a = 0.5 + rng.random(s.shape)
        elif leaf == "weights":
            a = 0.3 + rng.random(s.shape)
        else:  # biases, BN means
            a = 0.1 * rng.standard_normal(s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def variables_for(module, *args, seed: int = 0, **kwargs) -> dict:
    """``random_variables`` on the shapes of ``module.init(key, *args)``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return random_variables(dict(shapes), seed)


def load(port_module, variables: dict):
    port_module.load_state_dict(
        flax_to_state_dict(variables["params"], variables.get("batch_stats")), strict=True)
    return port_module


def _scaled_close(got, want, tol, msg=""):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale, rtol=tol,
                               atol=tol, err_msg=msg)


def _as_list(y) -> list:
    return list(y) if isinstance(y, (list, tuple)) else [y]


def hold_module(jm, pm, x, method=None, seed: int = 3, tol: float = TOL,
                zero_grad=lambda name: False):
    """``jm`` and ``pm`` (f32) on ``x`` (an NHWC array, or a list of them
    for a neck): eval outputs, train outputs with the running statistics
    they leave, and the gradients of ⟨outputs, ct⟩ in train mode to x and
    every parameter. ``method`` names a JAX method that returns a list of
    maps (the port module's of the same name). Gradients that are zero in
    exact arithmetic (``zero_grad(name)``: a BN bias whose output reaches
    the outputs only through convs into train-mode BNs, which remove a
    per-channel shift) are rounding noise on both sides and are held as
    zeros: within GRAD_TOL of the largest gradient."""
    many = isinstance(x, (list, tuple))
    as_jax = lambda: [jnp.asarray(a) for a in x] if many else jnp.asarray(x)  # noqa: E731
    variables = variables_for(jm, as_jax(), seed=seed)
    load(pm, variables)
    call = (lambda m, *a: getattr(m, method)(*a)) if method else (lambda m, *a: m(*a))
    with torch.no_grad():
        got_eval = call(pm, [torch.from_numpy(a) for a in x] if many else torch.from_numpy(x))
    rng = np.random.default_rng(seed)
    cts = [rng.standard_normal(tuple(g.shape)).astype(np.float32) for g in _as_list(got_eval)]
    stats = variables.get("batch_stats", {})

    def loss(params, x):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, x, True, method=method,
                            mutable=["batch_stats"])
        return sum(jnp.sum(o * c) for o, c in zip(_as_list(out), cts)), (out, mut)

    (_, (want_train, mut)), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"], as_jax())
    want_eval = jax.jit(lambda v, x: jm.apply(v, x, method=method))(variables, as_jax())
    for g, w in zip(_as_list(got_eval), _as_list(want_eval)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)
    tx = [torch.from_numpy(a).requires_grad_() for a in _as_list(x)]
    got_train = call(pm, tx if many else tx[0], True)
    torch.autograd.backward(_as_list(got_train), [torch.from_numpy(c) for c in cts])
    for g, w in zip(_as_list(got_train), _as_list(want_train)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=tol, atol=tol)
    for k, v in flax_to_state_dict({}, np_tree(mut.get("batch_stats", {}))).items():
        np.testing.assert_allclose(pm.state_dict()[k].numpy(), v.numpy(), rtol=tol, atol=tol,
                                   err_msg=k)
    for t, d in zip(tx, _as_list(jdx)):
        _scaled_close(t.grad.numpy(), d, GRAD_TOL, "dx")
    want = flax_to_state_dict(np_tree(jgrads))
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert sorted(got) == sorted(want)
    largest = max(float(v.abs().max()) for v in want.values())
    for k in want:
        if zero_grad(k):
            for side in (got[k], want[k]):
                assert float(side.abs().max()) <= GRAD_TOL * largest, (k, side, largest)
        else:
            _scaled_close(got[k].numpy(), want[k].numpy(), GRAD_TOL, k)


class DropPathMasks:
    """Keep masks from a numpy seed, one set per step in the JAX package's
    draw order, handed to ``jax.random.bernoulli`` where it draws drop-path
    masks ((B, 1, 1, 1); CutMix's coin passes through) and to the port's
    ``StochasticDepth.sample_scale`` (as mask / keep_p of the module)."""

    def __init__(self, monkeypatch, batch: int, per_step: int, seed: int = 11):
        rng = np.random.default_rng(seed)
        self.masks = [rng.random(batch) < 0.6 for _ in range(per_step)]
        self.masks[0][:2] = (True, False)  # a kept and a dropped sample at least
        self.jax_calls = self.port_calls = 0
        bernoulli = jax.random.bernoulli

        def jax_draw(key, p=0.5, shape=None):
            if shape is None or len(shape) != 4 or tuple(shape[1:]) != (1, 1, 1):
                return bernoulli(key, p, shape)
            mask = self.masks[self.jax_calls % len(self.masks)]
            self.jax_calls += 1
            return jnp.asarray(mask.reshape(shape))

        def port_draw(sd, batch, train=False, generator=None, *, device=None):
            if not train or sd.p == 0.0:
                return None
            mask = self.masks[self.port_calls % len(self.masks)]
            self.port_calls += 1
            return (torch.from_numpy(mask).reshape(batch, 1).float() / (1.0 - sd.p)).to(device)

        monkeypatch.setattr(jax.random, "bernoulli", jax_draw)
        monkeypatch.setattr(StochasticDepth, "sample_scale", port_draw)


def _trace(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
    return next(s for s in leaves if isinstance(s, optax.TraceState)).trace


def _as_np(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def run_steps(jax_backbone, port_backbone, dtype: str, n_steps: int, shape, seed: int = 1,
              port: bool = True):
    """Both classifier steps from one set of variables and draws (or the JAX
    one alone): the losses and, after each step, per side (parameters, BN
    statistics, momentum buffers) by port name, copied (SGD updates the
    port's tensors in place)."""
    jdt, tdt = DTYPES[dtype]
    jm = JaxClassifier(backbone=jax_backbone, num_classes=CLASSES, dtype=jdt)
    variables = variables_for(jm, jnp.zeros((1,) + tuple(shape[1:])), train=False, seed=seed)
    jstate = JaxState.create(jm.apply, variables,
                             jax_sgd(variables["params"], LR, momentum=0.9, weight_decay=2e-5))
    tstate = None
    if port:
        pm = load(ImageClassifier(port_backbone, CLASSES, dtype=tdt), variables)
        tstate = TrainState(pm, sgd_with_param_groups(pm, LR, momentum=0.9, weight_decay=2e-5))
        names = {id(p): n for n, p in pm.named_parameters()}
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, shape).astype(np.uint8)
    labels = rng.integers(0, CLASSES, shape[0]).astype(np.int32)
    jstep = jax.jit(jax_train_step(CLASSES, compute_dtype=jdt, **RECIPE))
    tstep = make_train_step(CLASSES, compute_dtype=tdt, **RECIPE)
    key, losses, states = jax.random.PRNGKey(SEED), [], []
    for i in range(n_steps):
        jstate, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), key)
        jax_side = (_as_np(flax_to_state_dict(np_tree(jstate.params))),
                    _as_np(flax_to_state_dict({}, np_tree(jstate.batch_stats))),
                    _as_np(flax_to_state_dict(np_tree(_trace(jstate.opt_state)))))
        port_side, loss = None, float("nan")
        if port:
            loss = float(tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels),
                               draws=step_draws(key, i, shape))["loss"])
            port_side = (
                {n: p.detach().numpy().copy() for n, p in tstate.model.named_parameters()},
                {n: b.numpy().copy() for n, b in tstate.model.named_buffers()},
                {names[id(p)]: b.numpy().copy() for (_, ps), bs in zip(tstate.optimizer.groups,
                                                                       tstate.optimizer.buffers)
                 for p, b in zip(ps, bs)})
        losses.append((loss, float(jmetrics["loss"])))
        states.append((port_side, jax_side))
    return losses, states


def check_steps(dtype: str, losses, states, f32_run=None) -> None:
    """The module docstring's bounds; ``f32_run`` is ``run_steps``'s return
    for the f32 step of the same model and data (its JAX side is read),
    needed in bf16."""
    kinds = ("parameters", "BN statistics", "momentum")
    for step, (port, jax_side) in enumerate(states):
        for got, want, what in zip(port, jax_side, kinds):
            assert sorted(got) == sorted(want), what
        if dtype == "float32":
            np.testing.assert_allclose(*losses[step], rtol=STEP_TOL, atol=STEP_TOL)
            for got, want, what in zip(port, jax_side, kinds):
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=STEP_TOL, atol=STEP_TOL,
                                               err_msg=f"step {step} {what} {k}")
            continue
        (got, want), ref_loss = losses[step], f32_run[0][step][1]
        assert min(abs(got - want), abs(got - ref_loss)) <= max(
            REL_L2 * abs(want), 2 * abs(want - ref_loss)), (step, got, want, ref_loss)
        ref = f32_run[1][step][1]
        ratios = []
        for got, want, r, what in zip(port, jax_side, ref, kinds):
            keys = sorted(want)
            flat = [np.concatenate([np.ravel(d[k]) for k in keys]) for d in (got, want, r)]
            e, own = rel_l2(flat[0], flat[1]), rel_l2(flat[1], flat[2])
            assert e <= max(REL_L2, 2 * own), (step, what, e, own)
            ratios += [rel_l2(got[k], r[k]) / max(rel_l2(want[k], r[k]), 1e-12) for k in keys]
        assert np.median(ratios) <= MEDIAN_RATIO, (step, np.median(ratios))
