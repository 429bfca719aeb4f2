"""1 − device busy time per profiled request (union over streams) / the
unprofiled window's time per request, in %."""


def read(run):
    tr = run.get("trace")
    if tr is None or "requests" not in run or not run["requests"]:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.units) / (run["window_s"] / run["requests"]))
