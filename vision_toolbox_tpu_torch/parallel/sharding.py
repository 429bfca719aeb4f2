"""Parameter sharding over the mesh — port of
``vision_toolbox_tpu/parallel/sharding.py``: tensor parallelism (big 2-D
kernels column-sharded over ``model``) and FSDP (every big parameter
sharded over ``data`` along its largest divisible dim), with gather-at-use.

The rules are decided on the parameter's **JAX-layout** shape, through
``utils/jax_bridge.jax_dims``, so that the same parameters shard as in the
JAX package: JAX's (in, out) column shard is dim 0 of the port's (out, in)
``Linear`` weight, and a conv's HWIO dims are the port's OIHW dims
permuted. Optimizer buffers follow their parameter by name: each buffer
list is aligned with the parameters of its group. Anything that is not a
parameter is replicated, BatchNorm statistics included.

The design chosen: **gather at use, one mechanism for TP and FSDP.** A
sharded parameter holds only this rank's slice (its ``nn.Parameter`` data
is the slice, so the optimizer steps on the shard and makes its buffers
like it). Just before the module that reads it runs, a forward pre-hook
all-gathers it over its axis and sets the whole tensor as that module's
attribute, which shadows the registered parameter until the module's
forward returns. The gather's backward returns this rank's slice of the
whole gradient: summed over the axis first where the axis is the data
axis (each data rank saw its own rows) and the gradient was not already
reduced where it was made (K3/K4's weight gradients,
``parallel/mesh.reduced_bf16``), as it is (the same on every rank) where it
is the model axis. Each gradient is reduced once. TP and FSDP differ only in their rule and
their axis. The function stays the same: each output column is the same
dot product over the whole K. Why: the fused half-block kernels K3 and K4
read whole weights (``nn/attention.float_linears``,
``fused_mlp_halfblock``), as JAX's GSPMD hands an opaque ``pallas_call``
replicated operands (``vision_toolbox_tpu/models/vit.py:115-116``);
splitting the products instead (column- and row-parallel linears) would
take the blocks off those kernels. The cost: the shards save parameter and
optimizer memory, not compute; each step moves the whole parameter once
in the gather and once in the gradient's all-reduce (gloo has no
reduce-scatter, so one path serves both backends).

The module that reads a parameter is taken to be the innermost element of
a ``ModuleList``/``Sequential`` that holds it (a block, whose forward may
hand its linears' weights to a fused kernel), else the parameter's own
module.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch import Tensor, nn

from ..utils.jax_bridge import jax_dims
from .mesh import Mesh, grad_reduced


def param_partition_spec(path: Any, shape: Sequence[int], mesh: Mesh, model_axis: str = "model",
                         min_size: int = 2**16) -> tuple:
    """Column-shard big 2-D kernels over the model axis; replicate the rest.
    ``shape`` is the JAX layout's; the spec names an axis or None per dim,
    ``()`` for replicated."""
    if model_axis not in mesh.axis_names:
        return ()
    axis_size = mesh.shape[model_axis]
    shape = tuple(shape)
    if len(shape) == 2 and math.prod(shape) >= min_size and shape[-1] % axis_size == 0:
        return (None, model_axis)
    return ()


def fsdp_partition_spec(path: Any, shape: Sequence[int], mesh: Mesh, data_axis: str = "data",
                        min_size: int = 2**16) -> tuple:
    """ZeRO-3: shard every large parameter over the data axis, along its
    largest divisible dim (the first of equal ones) of the JAX layout."""
    axis_size = mesh.shape[data_axis]
    shape = tuple(shape)
    if math.prod(shape) < min_size:
        return ()
    for dim in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[dim] % axis_size == 0:
            spec = [None] * len(shape)
            spec[dim] = data_axis
            return tuple(spec)
    return ()


def port_spec(name: str, ndim: int, jax_spec: tuple) -> tuple:
    """A spec over the JAX layout of parameter ``name``, over the port's
    dims."""
    if not jax_spec:
        return ()
    spec = [None] * ndim
    for jdim, pdim in enumerate(jax_dims(name, ndim)):
        spec[pdim] = jax_spec[jdim]
    return tuple(spec)


class Shard(NamedTuple):
    """How a parameter is split: over ``axis`` (its process group, size and
    this rank's coordinate) along port dim ``dim``; ``reduce`` when the axis
    is the data axis, whose ranks' gradients are summed in the gather's
    backward."""

    axis: str
    dim: int
    group: Any
    size: int
    coord: int
    reduce: bool


def shard_of(p: Tensor) -> Shard | None:
    return getattr(p, "_vtt_shard", None)


def _chunk(t: Tensor, s: Shard) -> Tensor:
    n = t.shape[s.dim] // s.size
    return t.narrow(s.dim, s.coord * n, n).contiguous()


def _gather(t: Tensor, s: Shard) -> Tensor:
    """The whole tensor of which ``t`` is this rank's shard."""
    if s.group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(s.size)]
    dist.all_gather(parts, t.contiguous(), group=s.group)
    return torch.cat(parts, s.dim)


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard: Tensor, s: Shard) -> Tensor:
        ctx.s, ctx.param = s, shard
        return _gather(shard, s)

    @staticmethod
    def backward(ctx, grad: Tensor):
        s = ctx.s
        if s.reduce and s.group is not None and not grad_reduced(ctx.param):
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=s.group)
        return _chunk(grad, s), None


def partition_specs(model: nn.Module, mesh: Mesh, fsdp: bool = False, model_axis: str = "model",
                    data_axis: str = "data", min_size: int = 2**16,
                    rule_fn: Callable | None = None) -> dict[str, tuple]:
    """Each parameter's spec over the port's dims (``()``: replicated), by
    the TP rule or, with ``fsdp``, the FSDP rule; ``rule_fn(name, param)``
    overrides both."""
    specs = {}
    for name, p in model.named_parameters():
        if rule_fn is not None:
            specs[name] = tuple(rule_fn(name, p))
            continue
        jshape = [p.shape[d] for d in jax_dims(name, p.ndim)]
        if fsdp:
            jspec = fsdp_partition_spec(name, jshape, mesh, data_axis, min_size)
        else:
            jspec = param_partition_spec(name, jshape, mesh, model_axis, min_size)
        specs[name] = port_spec(name, p.ndim, jspec)
    return specs


def optimizer_buffers(optimizer) -> list[tuple[Tensor, list, int]]:
    """Every per-parameter buffer of a ``GroupedOptimizer`` (or a
    ``MultiSteps`` around one) as (parameter, the list holding the buffer,
    its index): the lists are aligned with the groups' parameters."""
    out = []
    opts = [optimizer]
    if hasattr(optimizer, "inner"):  # MultiSteps: its running means, then the inner state
        opts = [optimizer.inner]
        if optimizer.acc is not None:
            for lst, (_, ps) in zip(optimizer.acc, optimizer.groups):
                out += [(p, lst, j) for j, p in enumerate(ps)]
    for opt in opts:
        for state_name in opt.STATE:
            lists = getattr(opt, state_name)
            for lst, (_, ps) in zip(lists or [], opt.groups):
                if lst is not None:
                    out += [(p, lst, j) for j, p in enumerate(ps) if lst[j] is not None]
    return out


def shard_train_state(state, mesh: Mesh, model_axis: str = "model", min_size: int = 2**16,
                      fsdp: bool = False, data_axis: str = "data",
                      rule_fn: Callable | None = None):
    """Shard a ``TrainState``'s whole parameters in place by the TP rule (or
    FSDP's with ``fsdp=True``; ``rule_fn(name, param)`` → a spec over the
    port's dims overrides both), the optimizer buffers of each sharded
    parameter with it (matched by the parameter they belong to, not by
    shape), and install the gathers at use. Returns ``state``."""
    model = state.model
    specs = partition_specs(model, mesh, fsdp, model_axis, data_axis, min_size, rule_fn)
    shards = {}
    for name, p in model.named_parameters():
        axes = [(d, a) for d, a in enumerate(specs[name]) if a is not None]
        if not axes:
            continue
        (dim, axis), = axes
        ax = mesh.axis(axis)
        s = Shard(axis, dim, ax.group, ax.size, ax.coord, axis == data_axis)
        shards[id(p)] = (p.shape, s)
        with torch.no_grad():
            p.data = _chunk(p.data, s)
        p._vtt_shard = s
    for p, lst, j in optimizer_buffers(state.optimizer):
        whole_shape, s = shards.get(id(p), (None, None))
        if s is not None and lst[j].shape == whole_shape:
            lst[j] = _chunk(lst[j], s)
    install_gathers(model)
    return state


def _reader(model: nn.Module, owner: str) -> str:
    """The module that reads the parameters of module ``owner``: the
    innermost element of a ``ModuleList``/``Sequential`` at or above it,
    else ``owner`` itself."""
    parts = owner.split(".") if owner else []
    for i in range(len(parts), 0, -1):
        if isinstance(model.get_submodule(".".join(parts[:i - 1])),
                      (nn.ModuleList, nn.Sequential)):
            return ".".join(parts[:i])
    return owner


def install_gathers(model: nn.Module) -> None:
    """Forward hooks that gather each sharded parameter of ``model`` at use
    (see the module docstring); once per model."""
    if getattr(model, "_vtt_gathers", None):
        return
    by_reader: dict[str, list] = {}
    for name, p in model.named_parameters():
        if shard_of(p) is not None:
            owner, _, leaf = name.rpartition(".")
            by_reader.setdefault(_reader(model, owner), []).append(
                (model.get_submodule(owner), leaf, p))
    handles = []
    for reader, entries in by_reader.items():
        def gather(module, args, entries=entries):
            for owner, leaf, p in entries:
                w = _GatherAtUse.apply(p, shard_of(p))
                w._vtt_param = p  # the parameter ``parallel/mesh.reduced_bf16`` marks
                owner.__dict__[leaf] = w

        def release(module, args, output, entries=entries):
            for owner, leaf, _ in entries:
                owner.__dict__.pop(leaf, None)

        m = model.get_submodule(reader)
        handles += [m.register_forward_pre_hook(gather),
                    m.register_forward_hook(release, always_call=True)]
    model._vtt_gathers = handles


def whole(t: Tensor, p: Tensor) -> Tensor:
    """``t`` (parameter ``p`` or a buffer made like it) as a whole tensor:
    gathered over ``p``'s axis where ``p`` is sharded (collective: every
    rank of that axis calls it)."""
    s = shard_of(p)
    return t if s is None or s.group is None else _gather(t.detach(), s)


def _sum_flat(params: list[Tensor], group) -> None:
    """Sum the gradients of ``params`` over ``group`` in one flat buffer (a
    missing gradient as a zero one)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def reduce_gradients(model: nn.Module, mesh: Mesh, data_axis: str = "data") -> None:
    """The whole gradients, as their global-batch mean over the data axis
    (equal local batches). First the partial ones: a module's
    ``partial_gradients()`` names, per mesh axis, the parameters whose
    gradient each rank of that axis holds a part of (a pipe axis's
    replicated parameters, ``parallel/pipeline.py``; the tokens' parameters
    under a ``seq`` axis, ``models/vit.py``), summed over it in one flat
    buffer. Then one all-reduce over the data axis, in one flat buffer, of
    every gradient that was not summed in a gather's backward or reduced
    where it was made (``parallel/mesh.grad_reduced``), and a division by
    the axis size of every gradient that is not yet a mean. A parameter
    without a gradient counts as a zero one, so that every rank reduces the
    same buffers."""
    partial: dict[str, list[Tensor]] = {}
    for m in model.modules():
        for name, ps in getattr(m, "partial_gradients", dict)().items():
            partial.setdefault(name, []).extend(ps)
    for name, ps in partial.items():
        if mesh.group(name) is not None and ps:
            _sum_flat(ps, mesh.group(name))
    axis = mesh.axis(data_axis)
    if axis.group is None:
        return
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    reduced = {id(p) for p in params if grad_reduced(p, clear=True)}
    summed = [p for p in params
              if id(p) not in reduced and not (shard_of(p) and shard_of(p).reduce)]
    if summed:
        _sum_flat(summed, axis.group)
    for p in params:
        if id(p) not in reduced:
            p.grad.div_(axis.size)
