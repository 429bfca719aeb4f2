"""Device-to-host reads per profiled step: the program's ``sync`` spans
(``utils/tracing.py`` ``to_host``: the host waits for the device) recorded
in the profiled steps. Nothing where the program records no ``step`` span."""


def read(run):
    tr = run.get("trace")
    if tr is None or "steps" not in run:
        return None
    try:
        from vision_toolbox_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.recorded()
    if not spans.get("step"):
        return None
    return len(spans.get("sync", ())) / tr.units
