"""Host ms per profiled request in the program's ``serve.prologue`` span
(``utils/export.py``: from the loaded program's call to the end of its
forward pre-hooks, the input-constraint check), under the profiler.
Nothing where the program records no such span."""


def read(run):
    if run.get("trace") is None or "requests" not in run:
        return None
    try:
        from vision_toolbox_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.recorded().get("serve.prologue")
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / len(spans)
