"""Pipeline parallelism (GPipe, and the interleaved schedule) over a ``pipe``
axis of ranks — port of ``vision_toolbox_tpu/parallel/pipeline.py``.

The JAX package runs the schedule as one SPMD program: inside
``jax.shard_map`` each device applies its ``(L/S, …)`` slice of the stacked
block parameters and ``lax.ppermute`` relays the activations around a ring.
Here one rank is one process on one device (``parallel/mesh.py``), and a
pipe rank holds only the block modules of its own chunks: with plain GPipe
the L/S layers of its stage, with interleave v the chunks d, d+S, …,
d+(v−1)S of L/(S·v) layers each. The model's own ``blocks`` (CaiT's
``sa_blocks``) run as they run in the sequential model, so every block
launches the kernels it launches there (K3/K4 for ViT/DeiT/DeiT3, K5 in
CaiT's talking-head attention, K3 on the Mixer's channel halves).

The schedule is JAX's, step for step. GPipe takes M + S − 1 steps, and
stage s holds microbatch t − s while 0 ≤ t − s < M. Interleaved takes
M + v·S − 1 steps, and at step t device d holds microbatch (t − d) mod S
at chunk t − that microbatch (M ≤ S keeps the shifted passes apart). A
rank runs its stage only on a real (microbatch, chunk), as JAX's
``skip_bubbles`` does; the port has no garbage path to switch to. Each
step's activations go to the next rank and come from the previous one in
one ``batch_isend_irecv`` (``parallel/mesh.exchange``); the last stage
sends its outputs on to the first for the next pass of the interleaved
ring, as JAX's ring ``ppermute`` does. The stage outputs are collected on
stage S−1 and broadcast to every pipe rank (JAX's ``psum`` of the masked
outputs), so that each holds the (B, …) features.

Backward is GPipe's: every microbatch's graph is kept, and the backward
runs the schedule in reverse, receiving each output's gradient from the
next stage and sending its input's gradient to the previous one. It is an
autograd function, so a plain ``loss.backward()`` on every rank drives it:
the block parameters' gradients accumulate where they are, and stage 0
passes its input's gradient on into the prologue. Everything outside the
blocks (patch embedding, PE, tokens, the norm, the pooler, the head,
CaiT's class-attention stage) is replicated over the pipe axis, as JAX's
``P()`` is: the prologue is backpropagated on stage 0 and the epilogue on
stage S−1 alone (the other ranks compute it without gradients), so that
the sum of those gradients over the pipe axis
(``parallel/sharding.reduce_gradients``, ``partial_gradients``) is the whole
gradient, bit-equal on every pipe rank.

The stages run with no data axis in sight (``parallel/mesh.local_rows``),
as inside JAX's ``shard_map``: K3/K4 round each microbatch's local weight
gradient to bf16, the microbatches' gradients accumulate in f32, and the
data axis is reduced once, after the backward, in f32 (unlike the
sequential sharded step, where ``reduced_bf16`` reduces K3/K4's f32 sums
before the rounding).

The stacked ``(L, …)`` layout lives on only as the checkpoint interchange:
``classifier_params_{to,from}_pipeline`` and a pipe run's checkpoints hold
``backbone_stacked.<block parameter>`` entries with a leading layer axis in
device-major chunk order, as JAX's pipeline state holds them.

Dropout and stochastic depth inside pipelined blocks are refused by the
trainer, as in JAX (the stages carry no rng streams).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor, nn
from torch.utils.checkpoint import checkpoint

from .mesh import Axis, Mesh, exchange, local_rows

# ---------------------------------------------------------------- layouts


def stack_block_params(state: dict[str, Tensor], prefix: str = "blocks.",
                       ) -> tuple[dict[str, Tensor], dict[str, Tensor]]:
    """Split a state dict into (stacked blocks, rest): the entries
    ``{prefix}<i>.<name>`` of blocks 0 … L−1 become ``<name>`` with a
    leading (L, …) layer axis."""
    blocks: dict[int, dict[str, Tensor]] = {}
    rest = {}
    for key, value in state.items():
        index, _, name = key[len(prefix):].partition(".")
        if key.startswith(prefix) and index.isdigit():
            blocks.setdefault(int(index), {})[name] = value
        else:
            rest[key] = value
    if not blocks:
        raise ValueError(f"no '{prefix}*' blocks in the state dict")
    stacked = {name: torch.stack([blocks[i][name] for i in range(len(blocks))])
               for name in blocks[0]}
    return stacked, rest


def unstack_block_params(stacked: dict[str, Tensor], rest: dict[str, Tensor] | None = None,
                         prefix: str = "blocks.") -> dict[str, Tensor]:
    """Inverse of ``stack_block_params``: back to the checkpoint layout."""
    out = dict(rest or {})
    depth = next(iter(stacked.values())).shape[0]
    for i in range(depth):
        out.update({f"{prefix}{i}.{name}": t[i] for name, t in stacked.items()})
    return out


def _interleave_order(depth: int, stages: int, interleave: int) -> np.ndarray:
    """Layer permutation of the interleaved schedule: device d's chunks
    (d, d+S, …, d+(v−1)S) laid out contiguously, device by device."""
    C = stages * interleave
    if depth % C:
        raise ValueError(f"depth {depth} not divisible by {stages} stages x "
                         f"{interleave} chunks")
    lc = depth // C
    return np.concatenate([
        np.arange((d + p * stages) * lc, (d + p * stages + 1) * lc)
        for d in range(stages)
        for p in range(interleave)
    ])


def interleave_block_params(stacked: dict[str, Tensor], stages: int,
                            interleave: int) -> dict[str, Tensor]:
    """Canonical (L, …) layer order → device-major chunk order."""
    if interleave == 1:
        return stacked
    order = torch.as_tensor(_interleave_order(next(iter(stacked.values())).shape[0], stages,
                                              interleave))
    return {k: t[order.to(t.device)] for k, t in stacked.items()}


def uninterleave_block_params(stacked: dict[str, Tensor], stages: int,
                              interleave: int) -> dict[str, Tensor]:
    """Inverse of ``interleave_block_params``: back to canonical order."""
    if interleave == 1:
        return stacked
    inv = torch.as_tensor(np.argsort(_interleave_order(
        next(iter(stacked.values())).shape[0], stages, interleave)))
    return {k: t[inv.to(t.device)] for k, t in stacked.items()}


def pipeline_block_prefix(model: nn.Module) -> str:
    """The state-dict prefix of ``model``'s pipelined stack: CaiT's
    self-attention blocks, else the blocks."""
    from ..models.cait import CaiT

    return "sa_blocks." if type(model) is CaiT else "blocks."


def classifier_params_to_pipeline(state: dict[str, Tensor], prefix: str = "blocks.",
                                  stages: int = 1, interleave: int = 1) -> dict[str, Tensor]:
    """An ``ImageClassifier`` state dict (the checkpoint layout) → the
    pipeline layout: ``backbone.<prefix><i>.<name>`` become
    ``backbone_stacked.<name>`` with a leading (L, …) axis in device-major
    chunk order; the rest keeps its names."""
    backbone = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    stacked, rest = stack_block_params(backbone, prefix)
    stacked = interleave_block_params(stacked, stages, interleave)
    out = {k: v for k, v in state.items() if not k.startswith("backbone.")}
    out.update({f"backbone.{k}": v for k, v in rest.items()})
    out.update({f"backbone_stacked.{k}": v for k, v in stacked.items()})
    return out


def classifier_params_from_pipeline(state: dict[str, Tensor], prefix: str = "blocks.",
                                    stages: int = 1, interleave: int = 1) -> dict[str, Tensor]:
    """Inverse of ``classifier_params_to_pipeline``: the standard layout,
    which the sequential model loads."""
    stacked = {k[len("backbone_stacked."):]: v for k, v in state.items()
               if k.startswith("backbone_stacked.")}
    stacked = uninterleave_block_params(stacked, stages, interleave)
    out = {k: v for k, v in state.items() if not k.startswith("backbone_stacked.")}
    out.update({f"backbone.{k}": v for k, v in
                unstack_block_params(stacked, None, prefix).items()})
    return out


# ------------------------------------------------------------------ stages


def owned_layers(depth: int, stages: int, interleave: int, device: int) -> list[int]:
    """The canonical indices of the layers device ``device`` holds, in its
    chunk order (its segment of ``_interleave_order``)."""
    order = _interleave_order(depth, stages, interleave)
    n = depth // stages
    return order[device * n:(device + 1) * n].tolist()


def make_stage_fn(train: bool = False, remat: bool = False,
                  **block_kw) -> Callable[[Sequence[nn.Module], Tensor], Tensor]:
    """Stage function applying a run of blocks in order:
    ``stage_fn(blocks, x)`` calls ``block(x, train, **block_kw)`` for each.
    ``remat=True`` checkpoints each layer (``torch.utils.checkpoint``, not
    reentrant), as JAX's ``jax.checkpoint`` wraps each layer: GPipe keeps
    every in-flight microbatch's activations, and recomputing each layer's
    is the memory lever. The global RNG state is not saved for the
    recompute: the port's blocks draw only from the ``generator`` they are
    given, and the stages are given none (the trainer refuses dropout and
    drop-path)."""

    def apply_block(block: nn.Module, h: Tensor) -> Tensor:
        return block(h, train, **block_kw)

    def stage_fn(blocks: Sequence[nn.Module], x: Tensor) -> Tensor:
        for block in blocks:
            if remat and torch.is_grad_enabled():
                x = checkpoint(apply_block, block, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = apply_block(block, x)
        return x

    return stage_fn


# ---------------------------------------------------------------- schedule


class _Schedule(NamedTuple):
    """One pipelined pass as a rank runs it."""

    stage_fn: Callable
    chunks: list  # this rank's v chunks of layers, pass by pass
    axis: Axis  # the pipe axis
    M: int
    v: int

    @property
    def C(self) -> int:
        return self.v * self.axis.size

    @property
    def steps(self) -> int:
        return self.M + self.C - 1

    def held(self, d: int, t: int) -> tuple[int, int] | None:
        """(microbatch, chunk) that device ``d`` computes at step ``t``, or
        None in a bubble."""
        S, d = self.axis.size, d % self.axis.size
        if self.v == 1:
            return (t - d, d) if 0 <= t - d < self.M else None
        m = (t - d) % S
        c = t - m
        return (m, c) if m < self.M and 0 <= c < self.C else None

    def relayed(self, d: int, t: int) -> bool:
        """Whether device ``d``'s output of step ``t`` goes on to the next
        rank (it is not the last chunk's)."""
        h = self.held(d, t)
        return h is not None and h[1] < self.C - 1

    def forward(self, x: Tensor, saved: dict | None) -> Tensor:
        """The forward schedule over ``x`` (this rank's rows); ``saved``
        (a dict) keeps each step's (input, output) for the backward. Returns
        the collected outputs, broadcast from stage S−1."""
        axis, d, S = self.axis, self.axis.coord, self.axis.size
        with torch.set_grad_enabled(saved is not None):
            xs = x.split(x.shape[0] // self.M)
        outs: list[Tensor | None] = [None] * self.M
        relay = None
        for t in range(self.steps):
            h, y = self.held(d, t), None
            if h is not None:
                m, c = h
                inp = xs[m] if c == 0 else relay
                if saved is not None and c > 0:
                    inp.requires_grad_()
                with torch.set_grad_enabled(saved is not None):
                    y = self.stage_fn(self.chunks[(c - d) // S], inp)
                if saved is not None:
                    saved[t] = (inp, y)
                if c == self.C - 1:
                    outs[m] = y.detach()
            relay = torch.empty_like(xs[0]) if self.relayed(d - 1, t) else None
            exchange(axis, y.detach() if self.relayed(d, t) else None, relay)
        out = torch.cat(outs) if d == S - 1 else torch.empty_like(x)
        dist.broadcast(out, dist.get_global_rank(axis.group, S - 1), group=axis.group)
        return out

    def backward(self, saved: dict, g: Tensor) -> None:
        """The reverse schedule: each output's gradient (``g``'s rows on the
        last stage, else received from the next rank) backpropagated
        through its step's graph, and the input's gradient sent to the
        previous rank."""
        axis, d = self.axis, self.axis.coord
        g_outs = g.split(g.shape[0] // self.M)
        relay = None
        for t in reversed(range(self.steps)):
            h, send = self.held(d, t), None
            if h is not None:
                m, c = h
                inp, y = saved.pop(t)
                torch.autograd.backward(y, g_outs[m] if c == self.C - 1 else relay)
                send = inp.grad if c > 0 else None
            relay = torch.empty_like(g_outs[0]) if t > 0 and self.relayed(d, t - 1) else None
            exchange(axis, send, relay, step=-1)


class _PipelineFunction(torch.autograd.Function):
    """The schedule as one autograd node over (x, this rank's block
    parameters): its forward keeps every step's graph, its backward runs
    the reverse schedule, accumulating the parameters' gradients where
    they are and returning x's (stage 0's; None elsewhere)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x: Tensor, *params: Tensor) -> Tensor:
        ctx.sched, ctx.n_params = sched, len(params)
        ctx.x = x.detach().requires_grad_()
        ctx.saved = {}
        with local_rows():
            return sched.forward(ctx.x, ctx.saved)

    @staticmethod
    def backward(ctx, g: Tensor):
        with local_rows():
            ctx.sched.backward(ctx.saved, g.contiguous())
        return (None, ctx.x.grad, *([None] * ctx.n_params))


def pipeline_apply(
    stage_fn: Callable[[Sequence[nn.Module], Tensor], Tensor],
    layers: Sequence[nn.Module],
    x: Tensor,
    *,
    mesh: Mesh,
    axis: str = "pipe",
    batch_axis: str | None = None,
    num_microbatches: int | None = None,
    interleave: int = 1,
) -> Tensor:
    """Run ``x`` through the L ``layers`` pipelined over ``mesh``'s ``axis``.

    ``layers``: the whole stack in canonical order, of which this rank
    touches only its own chunks (the others may be placeholders);
    ``stage_fn(chunk, mb)`` applies a run of layers to one microbatch and
    keeps its shape and type; ``x``: this rank's (B, …) rows (the rows of
    its ``batch_axis`` coordinate, where the batch is sharded over one).
    ``interleave=v`` runs the interleaved schedule. The rules are JAX's:
    ``L % (S·v) == 0``, the global batch divisible by M (which defaults to
    S), M ≤ S when interleaved, and the microbatch divisible by the batch
    axis; a pipe axis of 1 runs ``stage_fn`` on the whole stack and batch.
    Returns the (B, …) outputs on every pipe rank, differentiable with
    respect to ``x`` and the rank's layers (see the module docstring)."""
    S, v = mesh.axis_size(axis), interleave
    if v < 1:
        raise ValueError(f"interleave must be >= 1, got {v}")
    M = num_microbatches or max(S, 1)
    L = len(layers)
    dp = mesh.axis_size(batch_axis) if batch_axis else 1
    B = x.shape[0] * dp
    if L % (S * v):
        raise ValueError(f"depth {L} not divisible by {S} pipeline stages"
                         + (f" x {v} interleaved chunks" if v > 1 else ""))
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    if v > 1 and M > S:
        raise ValueError(f"interleaved schedule needs num_microbatches <= stages ({M} > {S}): "
                         "with M > S two passes of different microbatches collide on a "
                         "device at the same step")
    if batch_axis is not None and (B // M) % dp:
        raise ValueError(f"microbatch {B // M} not divisible by the {batch_axis}={dp} axis "
                         f"(global batch {B}, {M} microbatches)")
    if S == 1:
        return stage_fn(list(layers), x)
    ax = mesh.axis(axis)
    lc = L // (S * v)
    chunks = [list(layers[c * lc:(c + 1) * lc]) for c in range(ax.coord, S * v, S)]
    sched = _Schedule(stage_fn, chunks, ax, M, v)
    params = [p for chunk in chunks for layer in chunk for p in layer.parameters()]
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return _PipelineFunction.apply(sched, x, *params)
    with local_rows():
        return sched.forward(x, None)


class _LastStage(torch.autograd.Function):
    """``out``, computed from the pipeline's outputs without gradients on a
    rank that is not the last stage; its backward hands that rank's
    schedule a zero gradient (only the last stage's is read), so that the
    relay runs on every rank while the epilogue is backpropagated once."""

    @staticmethod
    def forward(ctx, out: Tensor, h: Tensor) -> Tensor:
        ctx.like = (h.shape, h.dtype, h.device)
        return out.clone()

    @staticmethod
    def backward(ctx, g: Tensor):
        shape, dtype, device = ctx.like
        return None, torch.zeros(shape, dtype=dtype, device=device)


def _on_last_stage(fn: Callable[[Tensor], Tensor], h: Tensor, mesh: Mesh,
                  axis: str = "pipe") -> Tensor:
    """``fn(h)`` on every pipe rank, differentiated on stage S−1 alone."""
    ax = mesh.axis(axis)
    if ax.coord == ax.size - 1 or not (torch.is_grad_enabled() and h.requires_grad):
        return fn(h)
    with torch.no_grad():
        out = fn(h.detach())
    return _LastStage.apply(out, h)


# ---------------------------------------------------------- family forwards


def _family(model: nn.Module) -> str:
    """The pipelined family of ``model``; an unknown class (a subclass
    with its own forward would compute another model) fails loudly."""
    from ..models.cait import CaiT
    from ..models.deit import DeiT
    from ..models.mlp_mixer import MLPMixer
    from ..models.vit import ViT

    kinds = {ViT: "vit", DeiT: "vit", CaiT: "cait", MLPMixer: "mixer"}
    if type(model) not in kinds:
        raise ValueError("pipeline forward mirrors ViT/DeiT/CaiT/MLP-Mixer exactly; got "
                         f"{type(model).__name__}")
    return kinds[type(model)]


def pipeline_forward_stacked(model: nn.Module, layers: Sequence[nn.Module], x: Tensor, *,
                             mesh: Mesh, axis: str = "pipe", batch_axis: str | None = None,
                             num_microbatches: int | None = None, train: bool = False,
                             remat: bool = False, interleave: int = 1,
                             head: Callable[[Tensor], Tensor] | None = None,
                             **block_kw) -> Tensor:
    """The forward of a ViT/DeiT/DeiT3, CaiT or MLP-Mixer with its block
    stack (``layers``, canonical order) pipelined over ``mesh[axis]``: the
    model's own prologue (patch embedding, PE, tokens: ``_tokens``) on
    every rank, its blocks through ``pipeline_apply``, and its own epilogue
    (the norm and the pooling, CaiT's class-attention stage: ``_pool``),
    then ``head`` where given, on every rank and differentiated on the last
    stage. ``block_kw`` goes to each block (``plain=True`` runs the kernels'
    plain versions, for checking the kernels; ``force_unfused=True`` the
    module chain). Numerically the sequential model: same parameters, same
    modules, only the schedule changes."""
    _family(model)
    h = pipeline_apply(make_stage_fn(train, remat, **block_kw), layers, model._tokens(x),
                       mesh=mesh, axis=axis, batch_axis=batch_axis,
                       num_microbatches=num_microbatches, interleave=interleave)

    def tail(h: Tensor) -> Tensor:
        out = model._pool(h, train)
        return out if head is None else head(out)

    return _on_last_stage(tail, h, mesh, axis)


def _stack(model: nn.Module) -> nn.ModuleList:
    return getattr(model, pipeline_block_prefix(model)[:-1])


def vit_pipeline_forward(vit: nn.Module, x: Tensor, **kw) -> Tensor:
    """ViT, DeiT or DeiT3 with its blocks pipelined (``pipeline_forward_stacked``
    on the model's own blocks); JAX's takes the variables, the port's
    modules hold theirs."""
    if _family(vit) != "vit":
        raise ValueError(f"pipeline forward mirrors ViT/DeiT exactly; got {type(vit).__name__}")
    return pipeline_forward_stacked(vit, vit.blocks, x, **kw)


def cait_pipeline_forward(cait: nn.Module, x: Tensor, **kw) -> Tensor:
    """CaiT with its self-attention stack pipelined; the patch embedding and
    the class-attention stage run replicated."""
    if _family(cait) != "cait":
        raise ValueError(f"expected CaiT, got {type(cait).__name__}")
    return pipeline_forward_stacked(cait, cait.sa_blocks, x, **kw)


def mixer_pipeline_forward(mixer: nn.Module, x: Tensor, **kw) -> Tensor:
    """MLP-Mixer with its blocks pipelined."""
    if _family(mixer) != "mixer":
        raise ValueError(f"expected MLPMixer, got {type(mixer).__name__}")
    return pipeline_forward_stacked(mixer, mixer.blocks, x, **kw)


# ----------------------------------------------------- the classifier's state


class PipelineClassifier(nn.Module):
    """An ``ImageClassifier`` on the pipeline: ``forward(x, train=False,
    generator=None)`` → f32 logits through ``pipeline_forward_stacked``,
    what the train and eval steps call (JAX's
    ``make_classifier_pipeline_apply``'s ``apply_fn``). It takes over the
    classifier's ``backbone`` and ``head`` and drops, in place, the blocks
    of other pipe ranks (placeholders keep the canonical names), so that a
    rank holds only its own blocks and an optimizer built on it only
    their state: the counterpart of JAX's ``pipeline_state_shardings``
    (blocks ``P(pipe)``, the rest replicated). ``partial_gradients`` names
    the replicated rest, whose gradients each pipe rank holds a part of
    (``parallel/sharding.reduce_gradients`` sums them over the axis).
    ``pipeline_state`` / ``load_pipeline_state`` are the checkpoint's
    pipeline layout (``utils/checkpoint.py``)."""

    def __init__(self, classifier: nn.Module, mesh: Mesh, *, axis: str = "pipe",
                 batch_axis: str | None = "data", num_microbatches: int | None = None,
                 remat: bool = False, interleave: int = 1):
        super().__init__()
        _family(classifier.backbone)
        self.backbone, self.head = classifier.backbone, classifier.head
        self.mesh, self.axis, self.batch_axis = mesh, axis, batch_axis
        self.num_microbatches, self.remat, self.interleave = num_microbatches, remat, interleave
        self.prefix = pipeline_block_prefix(self.backbone)
        blocks = _stack(self.backbone)
        self.owned = owned_layers(len(blocks), mesh.axis_size(axis), interleave,
                                  mesh.coord(axis))
        for i in range(len(blocks)):
            if i not in self.owned:
                blocks[i] = nn.Identity()

    def forward(self, x: Tensor, train: bool = False, generator: torch.Generator | None = None,
                *, plain: bool = False) -> Tensor:
        """``generator`` is taken for the step's signature: the stages draw
        nothing (the trainer refuses dropout and stochastic depth)."""
        return pipeline_forward_stacked(
            self.backbone, _stack(self.backbone), x, mesh=self.mesh, axis=self.axis,
            batch_axis=self.batch_axis, num_microbatches=self.num_microbatches, train=train,
            remat=self.remat, interleave=self.interleave, plain=plain,
            head=lambda f: self.head(f).float())

    def _block_names(self) -> dict[str, tuple[int, str]]:
        """This rank's block parameter names → (position in its chunk order,
        name within the block)."""
        pre = f"backbone.{self.prefix}"
        out = {}
        for name, _ in self.named_parameters():
            index, _, rel = name[len(pre):].partition(".")
            if name.startswith(pre) and index.isdigit():
                out[name] = (self.owned.index(int(index)), rel)
        return out

    def partial_gradients(self) -> dict[str, list[nn.Parameter]]:
        blocks = self._block_names()
        return {self.axis: [p for n, p in self.named_parameters() if n not in blocks]}

    def _to_layout(self, named: dict[str, Tensor]) -> dict[str, Tensor]:
        """Tensors named like this rank's parameters → the pipeline layout,
        the stacked entries gathered over the pipe axis (collective)."""
        blocks = self._block_names()
        out = {k: v for k, v in named.items() if k not in blocks}
        local: dict[str, list] = {}
        for name, (pos, rel) in blocks.items():
            if name in named:
                local.setdefault(rel, [None] * len(self.owned))[pos] = named[name]
        ax = self.mesh.axis(self.axis)
        for rel, ts in local.items():
            t = torch.stack(ts)
            if ax.group is not None:
                parts = [torch.empty_like(t) for _ in range(ax.size)]
                dist.all_gather(parts, t.contiguous(), group=ax.group)
                t = torch.cat(parts)
            out[f"backbone_stacked.{rel}"] = t
        return out

    def _from_layout(self, layout: dict[str, Tensor]) -> dict[str, Tensor]:
        """Inverse of ``_to_layout``: this rank's rows of the stacked
        entries under its parameter names."""
        n, d = len(self.owned), self.mesh.coord(self.axis)
        out = {k: v for k, v in layout.items() if not k.startswith("backbone_stacked.")}
        for name, (pos, rel) in self._block_names().items():
            key = f"backbone_stacked.{rel}"
            if key in layout:
                out[name] = layout[key][d * n + pos]
        return out

    def _optimizer_layout(self, state: dict, optimizer, save: bool) -> dict:
        """An optimizer state dict with each list of per-group lists
        (aligned with the groups' parameters: a ``GroupedOptimizer``'s
        ``STATE``, a ``MultiSteps``' ``acc``) put into the pipeline layout
        by parameter name (``save``), or taken back out of it."""
        names = {id(p): n for n, p in self.named_parameters()}
        groups = optimizer.groups
        out = dict(state)
        inner = getattr(optimizer, "inner", None)
        if inner is not None:
            out["inner"] = self._optimizer_layout(state["inner"], inner, save)
        for key in ("acc",) if inner is not None else optimizer.STATE:
            lists = state[key]
            if lists is None:
                continue
            if save:  # a group without state yet (None) has no entries
                out[key] = self._to_layout({names[id(p)]: t for ts, (_, ps) in zip(lists, groups)
                                            if ts is not None for t, p in zip(ts, ps)})
            else:
                local = self._from_layout(lists)
                out[key] = [[local[names[id(p)]] for p in ps] if names[id(ps[0])] in local
                            else None for _, ps in groups]
        return out

    def pipeline_state(self, optimizer) -> dict:
        """{"model", "optimizer"} in the pipeline layout, whole (collective:
        every pipe rank calls it)."""
        named = {k: v.detach() for k, v in self.state_dict().items()}
        return {"model": self._to_layout(named),
                "optimizer": self._optimizer_layout(optimizer.state_dict(), optimizer, True)}

    def load_pipeline_state(self, payload: dict, optimizer) -> None:
        """Load ``pipeline_state``'s payload: this rank's blocks and the
        rest, and the optimizer state that mirrors them."""
        self.load_state_dict(self._from_layout(payload["model"]))
        optimizer.load_state_dict(self._optimizer_layout(payload["optimizer"], optimizer, False))


def make_classifier_pipeline_apply(classifier: nn.Module, mesh: Mesh, *, axis: str = "pipe",
                                   batch_axis: str | None = "data",
                                   num_microbatches: int | None = None, remat: bool = False,
                                   interleave: int = 1) -> PipelineClassifier:
    """The classifier on the pipeline layout, as the train and eval steps
    call it (JAX's ``apply_fn``): a ``PipelineClassifier``."""
    return PipelineClassifier(classifier, mesh, axis=axis, batch_axis=batch_axis,
                              num_microbatches=num_microbatches, remat=remat,
                              interleave=interleave)
