"""Spans and counters: where a train step or a served request spends its
time, and how often the program does what costs.

**Spans.** ``span(name)`` marks a stretch of the program's work:

- Off, it returns one shared null context (two flag reads). It is off unless
  a ``torch.profiler`` records or a ``recording()`` block is open, and it is
  always off while ``torch.export`` or ``torch.compile`` traces, so exported
  graphs do not change.
- On, it opens ``torch.profiler.record_function("vtt:<name>")``, so the span
  lies on the profiler's timeline beside the operators and kernels launched
  inside it (a backward kernel is linked to the forward range it came from
  through the profiler's sequence numbers), and appends a ``Span`` (name,
  parent, host start and end in ns of the profiler's clock,
  ``time.time_ns``, thread id) to the recording. A span opened inside an
  open span of the same name on the same thread is that span (an optimizer
  wrapped around another).

``recording()`` turns spans on without a profiler; ``recorded()`` returns the
spans recorded since the last ``recording()`` block opened (or ``reset()``),
spans recorded under a profiler included, grouped by name.

The program's spans: ``step`` (``Trainer.train_batch``, one a step),
``draws``, ``input``, ``forward``, ``backward`` (``train/step.py``), ``optim``
(``train/optim.py``), ``allreduce`` (``shard_train_step``), ``block``
(``ViTBlock``), ``sync`` (a device-to-host read, ``to_host``), ``feed_wait``
(``DeviceFeed``), ``serve``, ``serve.prologue``, ``serve.graph``
(``utils/export.load_exported``) and ``build`` (``ops/_cuda.library_path``).

**Counters.** One registry of integers, always on (an integer add):
``count(name)`` adds to a counter; ``section(name)`` is a dict of counters
read as ``<name>/<key>`` (``launches``: ``ops/_cuda.LAUNCHES``, one count a
kernel launch); ``snapshot()`` reads every counter, flat, and ``delta(before)``
the ones that moved since a snapshot. ``host_syncs`` counts device-to-host
reads of CUDA tensors on a step's, a request's or the trainer's paths
(``to_host``), ``kernel_builds`` builds of the CUDA kernels' library.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, NamedTuple

import torch
import torch.autograd.profiler as _profiler

PREFIX = "vtt:"


class Span(NamedTuple):
    name: str
    parent: str | None  # the innermost span open on the thread when this one opened
    start_ns: int  # host clock of the profiler (time.time_ns)
    end_ns: int
    thread: int


_NULL = contextlib.nullcontext()
_recording = 0  # open recording() blocks
_spans: list[Span] = []
_local = threading.local()


def _stack() -> list[str]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _tracing_graph() -> bool:
    exporting = getattr(torch.compiler, "is_exporting", None)
    return torch.compiler.is_compiling() or (exporting is not None and exporting())


class _Open:
    __slots__ = ("name", "parent", "range", "start")

    def __init__(self, name: str, parent: str | None):
        self.name, self.parent = name, parent

    def __enter__(self):
        _stack().append(self.name)
        self.start = time.time_ns()
        self.range = _profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        _spans.append(Span(self.name, self.parent, self.start, end, threading.get_ident()))
        return False


def span(name: str):
    """A context manager marking ``name`` (see the module's docstring)."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    if _tracing_graph():
        return _NULL
    stack = _stack()
    parent = stack[-1] if stack else None
    if parent == name:
        return _NULL
    return _Open(name, parent)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans on, without a profiler; the outermost block starts a new
    recording."""
    global _recording
    if not _recording:
        _spans.clear()
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def reset() -> None:
    """Forget the recorded spans."""
    _spans.clear()


def recorded() -> dict[str, list[Span]]:
    """The spans of the current or last recording, grouped by name, each
    group in the order the spans closed."""
    out: dict[str, list[Span]] = {}
    for s in list(_spans):
        out.setdefault(s.name, []).append(s)
    return out


# counters
_counters: dict[str, int] = {"host_syncs": 0, "kernel_builds": 0}
_sections: dict[str, dict[str, int]] = {}


def count(name: str, n: int = 1) -> None:
    _counters[name] += n


def section(name: str, keys: tuple[str, ...] = ()) -> dict[str, int]:
    """The registry's section ``name``, a dict of counters read as
    ``<name>/<key>``; made the first time with ``keys`` at 0."""
    if name not in _sections:
        _sections[name] = dict.fromkeys(keys, 0)
    return _sections[name]


def snapshot() -> dict[str, int]:
    """Every counter, flat: ``host_syncs``, ``kernel_builds``,
    ``launches/<kernel>``, ..."""
    out = dict(_counters)
    for name, counters in _sections.items():
        out.update({f"{name}/{k}": v for k, v in counters.items()})
    return out


def delta(before: dict[str, int]) -> dict[str, int]:
    """The counters that moved since ``before`` (a ``snapshot()``), by how
    much."""
    return {k: v - before.get(k, 0) for k, v in snapshot().items() if v != before.get(k, 0)}


def to_host(t: torch.Tensor):
    """``t.tolist()`` (a number for a 0-d tensor). On a CUDA tensor the host
    waits for the device: that read counts in ``host_syncs`` and runs inside a
    ``sync`` span."""
    if not t.is_cuda:
        return t.tolist()
    _counters["host_syncs"] += 1
    with span("sync"):
        return t.tolist()
