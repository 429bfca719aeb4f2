"""A profiled sub-window, reduced to what the per-layer readers read.

Each device operation (kernel, copy, fill) is attributed to the host
operation that launched it, and through that operation to its context: the
names of every enclosing host event (operators, the benchmark's
``bench:<layer>`` ranges, Python frames with their source files). A
backward operation gets, besides its own context, the context of the forward
operation that made its autograd node (the profiler's sequence numbers link
them), after a ``<backward>`` marker. Busy time is the union of the device
operations' intervals.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

BACKWARD = "<backward>"
_EVALUATE = "autograd::engine::evaluate_function"


@dataclass
class Kernel:
    name: str
    seconds: float
    context: tuple[str, ...]


@dataclass
class Trace:
    units: int  # steps or requests profiled
    window_s: float  # host clock over the profiled sub-window
    busy_s: float
    kernels: list[Kernel]
    intervals: list[tuple[float, float, str]]  # device operations (s, s, name)
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)

    def seconds(self, where) -> float:
        """Device seconds of the operations whose context satisfies
        ``where``."""
        return sum(k.seconds for k in self.kernels if where(k.context))

    def device_ops(self, n: int = 10) -> list[list]:
        total: dict[str, float] = {}
        for a, b, name in self.intervals:
            total[name] = total.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def has(*names: str):
    """A context test: any entry equal to, or containing, one of
    ``names``."""
    return lambda ctx: any(any(n in c for n in names) for c in ctx)


def forward_part(ctx: tuple[str, ...]) -> tuple[str, ...]:
    return ctx[ctx.index(BACKWARD) + 1:] if BACKWARD in ctx else ctx


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _chain(e) -> list[str]:
    out = []
    while e is not None:
        out.append(e.name)
        e = e.cpu_parent
    return out


def _backward_seq(e) -> tuple[int, int] | None:
    while e is not None:
        if e.name.startswith(_EVALUATE) and e.sequence_nr >= 0:
            return e.fwd_thread, e.sequence_nr
        e = e.cpu_parent
    return None


def _idle_gaps(intervals, host_events, n: int = 10) -> list[tuple[str, float]]:
    """The longest gaps between device operations, each named by the
    innermost host event running at its middle."""
    gaps, end = [], None
    for a, b, _ in sorted(intervals):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid, best = (a + b) / 2, None
        for e in host_events:
            inner = best is None or e.end - e.start < best.end - best.start
            if e.start <= mid <= e.end and inner:
                best = e
        name = best.name[:120] if best is not None else "(host, outside any operator)"
        out.append((name, b - a))
    return out


@dataclass
class _Span:
    name: str
    start: float
    end: float


def reduce(prof, units: int, window_s: float) -> Trace:
    events = prof.events()
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    forward: dict[tuple[int, int], object] = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(_EVALUATE) and \
                "Backward" not in e.name and (e.thread, e.sequence_nr) not in forward:
            forward[(e.thread, e.sequence_nr)] = e
    kernels = []
    for e in cpu:
        if not e.kernels:
            continue
        ctx = _chain(e)
        link = _backward_seq(e)
        if link is not None and link in forward:
            ctx = ctx + [BACKWARD] + _chain(forward[link])
        ctx = tuple(ctx)
        for k in e.kernels:
            kernels.append(Kernel(k.name, k.duration / 1e6, ctx))
    intervals = []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            intervals.append((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name))
    host = [_Span(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6) for e in cpu]
    return Trace(units, window_s, union_seconds([(a, b) for a, b, _ in intervals]), kernels,
                 intervals, _idle_gaps(intervals, host))


def profile(fn, units: int, device_sync) -> Trace:
    """Run ``fn()`` ``units`` times under ``torch.profiler`` (host and
    device activity, Python stacks) and reduce the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    device_sync()
    with torch.profiler.profile(activities=acts, with_stack=True) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        device_sync()
        window = time.perf_counter() - t0
    return reduce(prof, units, window)


class Ranges:
    """``bench:<layer>`` ranges opened by forward hooks around modules."""

    def __init__(self):
        self.handles = []

    def add(self, module: torch.nn.Module, layer: str) -> None:
        stack = []

        def pre(mod, args):
            rf = torch.autograd.profiler.record_function(f"bench:{layer}")
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def close(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


@contextlib.contextmanager
def named(layer: str):
    with torch.autograd.profiler.record_function(f"bench:{layer}"):
        yield
