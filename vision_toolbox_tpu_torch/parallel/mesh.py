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
statistics over it (``nn/norm.py``), and dropout and drop-path draw their
masks for the global batch and keep this rank's rows (``draw_rows``), so a
step on n ranks draws what the step on one process draws.
"""

from __future__ import annotations

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


_ACTIVE: list[Axis] = []


@contextlib.contextmanager
def data_parallel(mesh: Mesh, axis: str = "data") -> Iterator[None]:
    """Within this block the modules see ``mesh``'s data axis
    (``active_data_axis``)."""
    _ACTIVE.append(mesh.axis(axis))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_data_axis() -> Axis | None:
    """The data axis of the sharded step that is running, else None."""
    return _ACTIVE[-1] if _ACTIVE else None


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
