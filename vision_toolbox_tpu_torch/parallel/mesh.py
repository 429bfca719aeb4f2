"""The rank mesh — port of ``vision_toolbox_tpu/parallel/mesh.py``.

In the JAX package one process drives a mesh of its local devices and
GSPMD inserts the collectives. In the port one rank is one process on one
device, and the mesh spans the ranks of a ``torch.distributed`` world:

- NCCL on the card and gloo on the CPU, ``env://`` initialisation as
  ``torchrun`` sets it (``init_process_group``); on a CUDA device the
  backend is NCCL or the run fails;
- the mesh's device count is the world size, and ranks are laid out
  row-major in the axis order, as ``np.asarray(devices).reshape(sizes)``
  lays out devices: each rank knows its coordinate on every axis and holds
  one process group per axis, the ranks that differ from it only there;
- the batch: a rank owns the rows of its **data-axis** coordinate
  (``batch_rows``). Ranks that differ only on ``model`` own the same rows,
  as JAX's ``P("data")`` replicates the batch over ``model``.

Without a process group (one process, no launcher) every axis has size 1
and no collective runs.

``data_parallel(mesh)`` marks the span of a sharded train step in which
the modules see the data axis (``active_data_axis``): BatchNorm reduces its
statistics over it (``nn/norm.py``), dropout and drop-path draw their
masks for the global batch and keep this rank's rows (``draw_rows``), so a
step on n ranks draws what the step on one process draws, and the
attention core decides its kernels' pair test on the global batch
(``ops/attention.py``). ``local_rows()`` hides the data axis again, as
JAX's ``shard_map`` shows each device its local rows: the pipeline's
stages run inside it (``parallel/pipeline.py``).

The pipeline and sequence parallelism add two kinds of collective:
``exchange`` posts one schedule step's sends and receives between pipe
neighbours as one batched call (NCCL matches point-to-point calls in
order, so no posting order can deadlock), and ``gather_tokens`` all-gathers
token slices over a ``seq`` axis (``TokenSharding``).
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
from dataclasses import dataclass, field
from typing import Callable, Iterator, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor


def init_process_group(device: torch.device | str | None = None) -> int:
    """Join the ``torch.distributed`` world that the launcher describes
    (``env://``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
    once: NCCL for a CUDA device (on the card ``LOCAL_RANK``, which becomes
    the current device), gloo for the CPU. Returns the world size; a second
    call returns it without joining again."""
    if dist.is_initialized():
        return dist.get_world_size()
    device = torch.device(device if device is not None else
                          "cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size()


def world() -> tuple[int, int]:
    """(rank, world size): ``torch.distributed``'s when it is initialized,
    else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class Mesh:
    """A grid of ranks: ``axis_names`` with ``axis_sizes``, this process's
    ``rank`` and one process group per axis (None without a process group)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    rank: int = 0
    groups: dict | None = field(default=None, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on every axis."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(self.rank, self.axis_sizes))))

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return None if self.groups is None else self.groups.get(axis)

    def axis(self, name: str) -> "Axis":
        return Axis(self.group(name), self.axis_size(name), self.coord(name))


class Axis(NamedTuple):
    """One mesh axis as a rank sees it: its process group (None without a
    process group), its size and this rank's coordinate on it."""

    group: object
    size: int
    coord: int


def create_mesh(axis_names: Sequence[str] = ("data",),
                axis_sizes: Sequence[int] | None = None) -> Mesh:
    """The mesh of the ranks of this world; by default a 1-D data-parallel
    mesh over all of them. A product of axis sizes other than the world size
    raises ``ValueError``. Every rank makes every group, in one order, as
    ``torch.distributed.new_group`` requires."""
    rank, size = world()
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = [size] + [1] * (len(axis_names) - 1)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if len(axis_sizes) != len(axis_names) or math.prod(axis_sizes) != size:
        raise ValueError(f"mesh {dict(zip(axis_names, axis_sizes))} needs "
                         f"{math.prod(axis_sizes)} ranks, the world has {size}")
    groups = None
    if dist.is_available() and dist.is_initialized():
        grid = np.arange(size).reshape(axis_sizes)
        groups = {}
        for i, axis in enumerate(axis_names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, axis_sizes[i]).tolist():
                group = dist.new_group(line)
                if rank in line:
                    groups[axis] = group
    return Mesh(axis_names, axis_sizes, rank, groups)


def batch_rows(mesh: Mesh, batch: int, axis: str = "data") -> slice:
    """The rows of a global batch of ``batch`` that this rank owns: those of
    its data-axis coordinate. A remainder raises ``ValueError``."""
    n = mesh.axis_size(axis)
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over the {axis!r} axis of size {n}")
    per = batch // n
    c = mesh.coord(axis)
    return slice(c * per, (c + 1) * per)


_ACTIVE: list[Axis | None] = []


@contextlib.contextmanager
def _active(axis: Axis | None) -> Iterator[None]:
    _ACTIVE.append(axis)
    try:
        yield
    finally:
        _ACTIVE.pop()


def data_parallel(mesh: Mesh, axis: str = "data"):
    """Within this block the modules see ``mesh``'s data axis
    (``active_data_axis``)."""
    return _active(mesh.axis(axis))


def local_rows():
    """Within this block no data axis is seen: the modules work on the
    rows they are given, as inside JAX's ``shard_map`` (the pipeline's
    stages: K3/K4 round each microbatch's local weight gradient to bf16, and
    the data axis is reduced once, after the step's backward)."""
    return _active(None)


def active_data_axis() -> Axis | None:
    """The data axis of the sharded step that is running, else None."""
    return _ACTIVE[-1] if _ACTIVE else None


def data_axis_size() -> int:
    """The size of the active data axis (1 outside a sharded step)."""
    axis = active_data_axis()
    return 1 if axis is None else axis.size


def draw_rows(draw: Callable[[int], Tensor], batch: int) -> Tensor:
    """``draw(n)`` makes a draw whose dim 0 is the batch. Inside a sharded
    step it is made for the global batch and this rank's rows are kept, so
    that every rank consumes its generator as one process does; elsewhere
    it is made for ``batch``."""
    axis = active_data_axis()
    if axis is None or axis.size == 1:
        return draw(batch)
    return draw(batch * axis.size)[axis.coord * batch:(axis.coord + 1) * batch]


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; its backward sums the gradients the same
    way (each rank's loss depends on every rank's contribution)."""

    @staticmethod
    def forward(ctx, t: Tensor, group) -> Tensor:
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: Tensor, axis: Axis) -> Tensor:
    """Differentiable sum of ``t`` over ``axis`` (``t`` itself without a
    process group)."""
    return t if axis.group is None else _AllReduceSum.apply(t, axis.group)


def reduced_bf16(t: Tensor, of: Tensor) -> Tensor:
    """An f32 weight gradient over this rank's rows, the gradient of ``of``,
    rounded to bf16 as the one-process step rounds the whole batch's. Inside
    a sharded step whose data axis is above 1 the ranks' f32 sums are
    all-reduced first, as JAX's GSPMD reduces the f32 product over the
    sharded rows before its cast (rounding each rank's share would differ by
    up to a bf16 rounding per rank), and each rank keeps 1/n of the rounded
    sum, the global mean. The parameter that ``of`` is, or was gathered
    from, is then marked (``grad_reduced``), so that the gradient all-reduce
    passes it by and its gradient is reduced once."""
    axis = active_data_axis()
    if axis is None or axis.size == 1 or axis.group is None:
        return t.to(torch.bfloat16)
    t = t.contiguous()
    dist.all_reduce(t, group=axis.group)
    getattr(of, "_vtt_param", of)._vtt_grad_reduced = True
    return t.to(torch.bfloat16).float() / axis.size


def grad_reduced(p: Tensor, clear: bool = False) -> bool:
    """Whether parameter ``p``'s gradient of this step is already the global
    mean over the data axis (``reduced_bf16``); ``clear`` removes the mark."""
    if clear:
        return p.__dict__.pop("_vtt_grad_reduced", False)
    return getattr(p, "_vtt_grad_reduced", False)


def rolled_rows(t: Tensor, axis: Axis | None) -> Tensor:
    """``roll(1, 0)`` of the global batch, of which ``t`` holds this rank's
    rows along ``axis``: row 0 takes the last row of the previous data rank
    (around the ring), so one row crosses each rank boundary."""
    if axis is None or axis.group is None:
        return t.roll(1, 0)
    last = t[-1:].contiguous()
    rows = [torch.empty_like(last) for _ in range(axis.size)]
    dist.all_gather(rows, last, group=axis.group)
    return torch.cat([rows[(axis.coord - 1) % axis.size], t[:-1]])


def exchange(axis: Axis, send: Tensor | None = None, recv: Tensor | None = None,
             step: int = 1) -> None:
    """One step of a ring relay over ``axis``: ``send`` goes to the rank
    ``step`` coordinates on (around the ring) and ``recv`` is filled from the
    rank ``step`` coordinates back, both posted in one ``batch_isend_irecv``
    and waited on (``step=-1``: against the ring, the pipeline's backward).
    A rank passes None for a message the schedule does not have; the
    schedule makes every send meet its receive."""
    peer = lambda k: dist.get_global_rank(axis.group, (axis.coord + k) % axis.size)
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), peer(step), axis.group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, peer(-step), axis.group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()


class TokenSharding(NamedTuple):
    """(B, T, D) token activations split over ``mesh``'s ``seq`` axis along
    the tokens and its ``batch`` axis along the rows: JAX's
    ``NamedSharding(mesh, P("data", "seq"))`` for ``ViT.token_sharding``.
    Ranks that differ only on ``seq`` hold the same rows."""

    mesh: Mesh
    seq: str = "seq"
    batch: str | None = "data"


class SeqShard(NamedTuple):
    """One token-sharded attention as a rank sees it: the ``axis`` its K
    and V are gathered over, and the unsharded (``rows``, ``tokens``) its
    kernels' rules are decided on (what JAX's GSPMD trace sees)."""

    axis: Axis
    rows: int
    tokens: int


GATHERS: collections.Counter = collections.Counter()  # token all-gathers by kind, counted


def _all_gather_dim1(t: Tensor, axis: Axis) -> Tensor:
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return torch.cat(parts, dim=1)


class _GatherTokens(torch.autograd.Function):
    """All-gather along dim 1 over a seq axis. ``summed``: every rank's
    use of the whole differs (K and V under each rank's queries), so the
    backward sums the ranks' gradients, then keeps this rank's slice; else
    every rank uses the whole alike (the tokens before the norm), so the
    backward keeps the slice of its own gradient."""

    @staticmethod
    def forward(ctx, t: Tensor, axis: Axis, summed: bool) -> Tensor:
        ctx.axis, ctx.summed, ctx.n = axis, summed, t.shape[1]
        return _all_gather_dim1(t, axis)

    @staticmethod
    def backward(ctx, grad: Tensor):
        axis = ctx.axis
        if ctx.summed:  # gloo has no reduce-scatter: all-reduce, then slice
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=axis.group)
        return grad[:, axis.coord * ctx.n:(axis.coord + 1) * ctx.n], None, None


def gather_tokens(t: Tensor, axis: Axis, summed: bool, kind: str) -> Tensor:
    """``t`` (B, T/n, ...) gathered whole along dim 1 over ``axis`` (see
    ``_GatherTokens`` for ``summed``); counted under ``kind`` in
    ``GATHERS``."""
    GATHERS[kind] += 1
    return t if axis.group is None else _GatherTokens.apply(t, axis, summed)
